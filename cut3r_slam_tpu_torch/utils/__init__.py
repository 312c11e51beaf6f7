"""Config loading, the host frame store and headless map dumps."""
