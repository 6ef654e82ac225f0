from .profiling import PhaseTimer, trace  # noqa: F401
