"""The assigned architectures' configs and the registry over them."""
from .registry import (ARCHS, LONG_OK, SHAPES, get_config,  # noqa: F401
                       shape_supported, smoke_config)
