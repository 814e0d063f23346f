"""The serving daemon's core (`SamplerService`) and its HTTP front end."""

from .http import decode_images, make_server, serve_forever
from .service import SamplerService, ServingConfig

__all__ = [
    "SamplerService",
    "ServingConfig",
    "make_server",
    "serve_forever",
    "decode_images",
]
