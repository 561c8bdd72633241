# registers the stem and int8 ops (ops/library.py) with PyTorch's dispatcher
# before any module of the package runs them
from . import library  # noqa: F401
