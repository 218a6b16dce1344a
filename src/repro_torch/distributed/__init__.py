from .straggler import StragglerConfig, StragglerMonitor

__all__ = ["StragglerConfig", "StragglerMonitor"]
