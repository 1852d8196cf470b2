from . import llm

__all__ = ["llm"]
