from .feed import ChangeLog  # noqa: F401
