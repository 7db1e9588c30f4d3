from . import adamw, compress
