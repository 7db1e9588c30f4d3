from . import manager
