from .cut3r import CUT3R, CUT3RConfig, normalize_images  # noqa: F401
