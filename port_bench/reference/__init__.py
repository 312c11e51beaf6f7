"""The benchmark's plain reference: frozen float32 copies of CUT3R's
forward (``cut3r.py``), its training loss and optimizer (``train.py``),
the plain Gaussian rasterizer with its blend-work counter (``raster.py``)
and the mapper's Adam (``adam.py``). Plain PyTorch; nothing here imports
the program, JAX or the JAX package."""
