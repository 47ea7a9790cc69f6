"""The port's video helpers (`videocof_torch/utils/video_io.py`:
`color_transfer`, `save_videos_grid`, `get_video_to_video_latent`,
`merge_video_audio`) against the JAX package's, on seeded numpy frames and
on clips and images written with cv2 and PIL. JAX decodes a path through
its cv2 fallback (`videocof_tpu.runtime._load` patched to None), as the
port does; every comparison is bit for bit."""

import cv2
import numpy as np
import pytest
from PIL import Image

import videocof_tpu.runtime as jruntime
import videocof_tpu.utils.video_io as jvio
import videocof_torch.utils as utils
import videocof_torch.utils.video_io as vio


def _frames(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_exported_under_jax_names():
    import videocof_tpu.utils as jutils
    for name in jutils.__all__:
        if callable(getattr(jutils, name)):
            assert getattr(utils, name) is getattr(vio, name), name
    assert utils.get_video_to_video_latent is vio.get_video_to_video_latent


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_color_transfer_matches_jax(seed):
    src = _frames(seed, (24, 40, 3))
    # a reference of other statistics: darker and less varied
    ref = (_frames(seed + 10, (24, 40, 3)) // 3 + 40).astype(np.uint8)
    got = vio.color_transfer(src, ref)
    np.testing.assert_array_equal(got, jvio.color_transfer(src, ref))
    assert got.dtype == np.uint8 and got.shape == src.shape
    flat = np.zeros_like(src) + 7          # one colour: the std floor
    np.testing.assert_array_equal(vio.color_transfer(flat, ref),
                                  jvio.color_transfer(flat, ref))


@pytest.mark.parametrize("batch,n_rows", [(1, 6), (3, 2), (5, 2), (4, 6),
                                          (7, 3)])
@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("pin", [False, True])
def test_save_videos_grid_matches_jax(monkeypatch, batch, n_rows, rescale,
                                      pin):
    """The tiled array that reaches `save_video` (padded batches, both
    value ranges, with and without the colour pin), and its fps."""
    seen = {}

    def capture(side):
        def save(video, path, fps=16):
            seen[side] = (np.array(video), path, fps)
        return save
    monkeypatch.setattr(vio, "save_video", capture("port"))
    monkeypatch.setattr(jvio, "save_video", capture("jax"))
    rng = np.random.default_rng(batch * 10 + n_rows)
    videos = rng.uniform(-1.2, 1.2, (batch, 3, 4, 8, 12)).astype(np.float32)
    kw = dict(rescale=rescale, n_rows=n_rows,
              color_transfer_post_process=pin)
    vio.save_videos_grid(videos, "port.mp4", **kw)
    jvio.save_videos_grid(videos, "jax.mp4", **kw)
    got, want = seen["port"], seen["jax"]
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2] == 12
    cols = min(n_rows, batch)
    assert got[0].shape == (3, 4, -(-batch // cols) * 8, cols * 12)


def test_save_videos_grid_one_clip_matches_jax(monkeypatch):
    seen = []
    monkeypatch.setattr(vio, "save_video", lambda v, p, fps=16: seen.append(v))
    monkeypatch.setattr(jvio, "save_video",
                        lambda v, p, fps=16: seen.append(v))
    clip = np.random.default_rng(4).uniform(0, 1, (3, 5, 8, 8))
    vio.save_videos_grid(clip, "a.mp4", fps=8)
    jvio.save_videos_grid(clip, "b.mp4", fps=8)
    np.testing.assert_array_equal(seen[0], seen[1])


def test_save_videos_grid_writes_a_tiled_clip(tmp_path):
    """Through cv2: the frame count and the tiled size read back."""
    videos = np.random.default_rng(5).uniform(0, 1, (3, 3, 6, 16, 24))
    path = str(tmp_path / "grid.mp4")
    vio.save_videos_grid(videos, path, n_rows=2,
                         color_transfer_post_process=True)
    frames, h, w, _ = vio.video_info(path)
    assert (frames, h, w) == (6, 32, 48)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 20-frame 36x52 clip at 24 fps, written with cv2's mp4v, and the
    frames read back."""
    path = str(tmp_path_factory.mktemp("v2v") / "clip.mp4")
    frames = _frames(7, (20, 36, 52, 3))
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                             (52, 36))
    assert writer.isOpened()
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    return path


@pytest.fixture()
def jax_cv2(monkeypatch):
    """JAX's runtime on its cv2 fallback, as the port decodes."""
    monkeypatch.setattr(jruntime, "_load", lambda: None)


def _same(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fps,length,size", [(None, 9, (32, 48)),
                                             (8, 9, (40, 56)),
                                             (12, 4, (36, 52))])
def test_video_to_video_latent_path_matches_jax(jax_cv2, clip, fps, length,
                                                size):
    """A path: the fps walk (one frame in 24 // fps), at most ``length``
    frames, each resized by cv2's default; all-255 mask."""
    got = vio.get_video_to_video_latent(clip, length, size, fps=fps)
    _same(got, jvio.get_video_to_video_latent(clip, length, size, fps=fps))
    video, mask = got[:2]
    skip = 1 if fps is None else 24 // fps
    assert video.shape == (1, 3, min(length, -(-20 // skip))) + size
    assert video.min() >= 0.0 and video.max() <= 1.0
    assert mask.shape == (1, 1, video.shape[2]) + size
    assert (mask == 255.0).all()


def test_video_to_video_latent_array_mask_and_ref_match_jax(jax_cv2, clip,
                                                            tmp_path):
    """An array input; a mask image (PIL 'L', resized, < 240 -> 0); a ref
    image as a path (resized) and as an array (kept at its size)."""
    size = (32, 48)
    arr = _frames(8, (6, 32, 48, 3))
    gray = np.random.default_rng(9).integers(200, 256, (20, 30),
                                             dtype=np.uint8)
    mask_path = str(tmp_path / "mask.png")
    Image.fromarray(gray, "L").save(mask_path)
    ref = _frames(10, (24, 36, 3))
    ref_path = str(tmp_path / "ref.png")
    Image.fromarray(ref).save(ref_path)
    for source in (arr, clip):
        for ref_image in (ref_path, ref, None):
            kw = dict(validation_video_mask=mask_path, ref_image=ref_image)
            got = vio.get_video_to_video_latent(source, 5, size, **kw)
            _same(got, jvio.get_video_to_video_latent(source, 5, size, **kw))
            video, mask, ref_out, clip_image = got
            assert video.shape == (1, 3, 5) + size
            assert set(np.unique(mask)) == {0.0, 255.0}
            if ref_image is None:
                assert ref_out is None and clip_image is None
            else:
                want_hw = size if isinstance(ref_image, str) else (24, 36)
                assert ref_out.shape == (1, 3, 1) + want_hw
                np.testing.assert_array_equal(clip_image, ref)
    _same(vio.get_video_to_video_latent(None, 5, size, ref_image=ref),
          jvio.get_video_to_video_latent(None, 5, size, ref_image=ref))


def test_merge_video_audio_errors_match_jax(monkeypatch, tmp_path):
    """A missing input raises FileNotFoundError; without ffmpeg on PATH,
    RuntimeError; on both sides."""
    video, audio = tmp_path / "v.mp4", tmp_path / "a.wav"
    for merge in (vio.merge_video_audio, jvio.merge_video_audio):
        with pytest.raises(FileNotFoundError, match="video file"):
            merge(str(video), str(audio))
    video.write_bytes(b"\0")
    for merge in (vio.merge_video_audio, jvio.merge_video_audio):
        with pytest.raises(FileNotFoundError, match="audio file"):
            merge(str(video), str(audio))
    audio.write_bytes(b"\0")
    monkeypatch.setenv("PATH", "")
    for merge in (vio.merge_video_audio, jvio.merge_video_audio):
        with pytest.raises(RuntimeError, match="ffmpeg"):
            merge(str(video), str(audio))
    assert video.read_bytes() == b"\0"
