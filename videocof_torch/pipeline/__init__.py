from .wan_pipeline import WanPipeline, WanPipelineOutput, latent_frame_count
from .varlen import batch_edit
from .wan22_pipeline import Wan22Pipeline

__all__ = ["WanPipeline", "WanPipelineOutput", "Wan22Pipeline",
           "latent_frame_count", "batch_edit"]
