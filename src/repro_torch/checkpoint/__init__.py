from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
