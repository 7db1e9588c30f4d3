"""Command-line entry points of the port."""
from .mesh import data_axes, make_mesh, make_production_mesh
