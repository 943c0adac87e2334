from . import shuffle  # noqa: F401
