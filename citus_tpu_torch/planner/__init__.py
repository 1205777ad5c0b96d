from . import expr
from .bind import Binder, BoundQuery, DictProvider
from .plan import DistributedPlanner, QueryPlan, StatsProvider

__all__ = ["expr", "Binder", "BoundQuery", "DictProvider",
           "DistributedPlanner", "QueryPlan", "StatsProvider"]
