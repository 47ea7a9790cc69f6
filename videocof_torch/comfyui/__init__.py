"""ComfyUI registration hook: put the repository (or a link to it) in
ComfyUI's ``custom_nodes/`` and the nodes register. The nodes are plain
classes with ComfyUI's structural contract, so the module imports without
ComfyUI."""

from .comfyui_nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
