from .attention import attention, available_backends, default_backend

__all__ = ["attention", "available_backends", "default_backend"]
