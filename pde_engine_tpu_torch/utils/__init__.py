from .config import SearchConfig  # noqa: F401
