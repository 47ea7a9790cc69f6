"""Training data: the CoT triplet dataset, buckets, the prefetch loader,
the other dataset families, masks and camera poses (counterpart of
`videocof_tpu/data/`)."""

from .instructions import derive_ground_object_from_instruction, build_cot_prompt
from .tokenizer import WanTokenizer
from .dataset import (CoTTripletDataset, apply_gray_overlay,
                      apply_gray_region_effect, build_gray_mask,
                      interpolate_ground_frames)
from .datasets_extra import (ImageVideoControlDataset, ImageVideoDataset,
                             VideoEditDataset, VideoEditReasoningDataset)
from .datasets_legacy import (CC15M, VideoDataset, WebVid10M,
                              legacy_random_mask)
from .camera import (CameraPose, plucker_rays, pose_params_to_embedding,
                     process_pose_file, relative_poses)

__all__ = ["derive_ground_object_from_instruction", "build_cot_prompt",
           "WanTokenizer", "CoTTripletDataset", "interpolate_ground_frames",
           "build_gray_mask", "apply_gray_region_effect",
           "apply_gray_overlay", "ImageVideoDataset",
           "ImageVideoControlDataset", "VideoEditDataset",
           "VideoEditReasoningDataset", "VideoDataset", "WebVid10M", "CC15M",
           "legacy_random_mask", "CameraPose", "plucker_rays",
           "pose_params_to_embedding", "process_pose_file",
           "relative_poses"]
