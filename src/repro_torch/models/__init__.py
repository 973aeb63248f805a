from .config import ModelConfig

__all__ = ["ModelConfig"]
