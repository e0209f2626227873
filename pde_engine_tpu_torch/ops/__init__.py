from . import jets, optable, tape  # noqa: F401
