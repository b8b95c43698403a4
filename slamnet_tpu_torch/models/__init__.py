from . import fleet, hector

__all__ = ["fleet", "hector"]
