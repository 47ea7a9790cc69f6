from .wan_pipeline import WanPipeline, WanPipelineOutput, latent_frame_count
from .varlen import batch_edit
from .wan22_pipeline import Wan22Pipeline
from .vace_pipeline import VacePipeline
from .camera_pipeline import CameraPipeline
from .s2v_pipeline import S2VPipeline
from .image_pipelines import (CogVideoXPipeline, FluxPipeline,
                              QwenImagePipeline, calculate_mu_shift)

__all__ = ["WanPipeline", "WanPipelineOutput", "Wan22Pipeline",
           "VacePipeline", "CameraPipeline", "S2VPipeline",
           "CogVideoXPipeline", "QwenImagePipeline", "FluxPipeline",
           "calculate_mu_shift", "latent_frame_count", "batch_edit"]
