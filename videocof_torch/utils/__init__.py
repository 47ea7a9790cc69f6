from .video_io import (color_transfer, get_image_to_video_latent,
                       get_video_to_video_latent, load_video_frames,
                       merge_video_audio, save_results, save_side_by_side,
                       save_video, save_videos_grid)

__all__ = ["load_video_frames", "save_video", "save_side_by_side",
           "save_results", "save_videos_grid", "color_transfer",
           "merge_video_audio", "get_image_to_video_latent",
           "get_video_to_video_latent"]
