from . import coreslam, fleet, graph_slam, hector

__all__ = ["coreslam", "fleet", "graph_slam", "hector"]
