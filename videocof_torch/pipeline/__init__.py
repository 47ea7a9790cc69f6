from .wan_pipeline import WanPipeline, WanPipelineOutput, latent_frame_count
from .varlen import batch_edit

__all__ = ["WanPipeline", "WanPipelineOutput", "latent_frame_count",
           "batch_edit"]
