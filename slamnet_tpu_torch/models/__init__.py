from . import hector

__all__ = ["hector"]
