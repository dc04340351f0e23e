from .dataset import GraphData, PartitionedGraphData
from .partition_book import RangePartitionBook
from . import synthetic

__all__ = ["GraphData", "PartitionedGraphData", "RangePartitionBook",
           "synthetic"]
