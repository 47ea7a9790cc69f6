"""Serving: the controller over a resident pipeline, the HTTP API
(`serving.api`), its web page and the worker pool (`serving.multihost`)."""

from .controller import VideoCoFClient, VideoCoFController

__all__ = ["VideoCoFController", "VideoCoFClient"]
