"""The port's data package against the JAX package's, bit for bit on the
arrays: the CoT triplet dataset in each of its modes (gradual grounding, the
three gray visualizations, text drop, retry past a missing file) on cv2
clips written to a temporary directory, the bucket helpers, the random
masks, the camera poses and the other dataset families. Both sides read the
same files, so any decoder inexactness is the same on both."""

import csv
import json

import numpy as np
import pytest

import videocof_torch.data as pdata
import videocof_tpu.data as jdata
from videocof_torch.data import buckets as pbuckets
from videocof_torch.data import camera as pcamera
from videocof_torch.data import dataset as pdataset
from videocof_torch.data import masks as pmasks
from videocof_tpu.data import buckets as jbuckets
from videocof_tpu.data import camera as jcamera
from videocof_tpu.data import dataset as jdataset
from videocof_tpu.data import masks as jmasks

cv2 = pytest.importorskip("cv2")


def _write_clip(path, frames, hw, seed):
    rng = np.random.default_rng(seed)
    h, w = hw
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10,
                             (w, h))
    assert writer.isOpened(), "no mp4 codec in this cv2 build"
    for i in range(frames):
        frame = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        frame[: h // 3, : w // 3] = 128              # a gray region
        frame[h // 2:, w // 2:] = (i * 11) % 256
        writer.write(frame)
    writer.release()
    return path


def _same(got, want, path="sample"):
    """Equal values, types and dtypes, recursively."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            _same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, path


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    p = {}
    for name, frames, hw, seed in (("orig", 20, (48, 64), 0),
                                   ("ground", 20, (48, 64), 1),
                                   ("edit", 18, (48, 64), 2),
                                   ("tall", 12, (64, 40), 3)):
        p[name] = _write_clip(str(root / f"{name}.mp4"), frames, hw, seed)
    items = [{"original_video": "orig.mp4", "grounded_video": "ground.mp4",
              "edited_video": "edit.mp4", "edit_instruction":
              "remove the box"},
             {"original_video": "tall.mp4", "grounded_video": "tall.mp4",
              "edited_video": "orig.mp4",
              "edit_instruction": "replace the cat with a dog"},
             {"original_video": "missing.mp4", "edit_instruction": "x"}]
    p["json"] = str(root / "train.json")
    with open(p["json"], "w") as f:
        json.dump(items, f)
    img = str(root / "still.png")
    cv2.imwrite(img, np.random.default_rng(5).integers(
        0, 255, (48, 64, 3), dtype=np.uint8))
    p["img"] = img
    pose = str(root / "pose.txt")
    with open(pose, "w") as f:
        f.write("header\n")
        for i in range(6):
            w2c = np.eye(4)[:3].copy()
            w2c[0, 3] = 0.05 * i
            w2c[2, 3] = 0.1 * i
            row = [i, 0.5, 0.9, 0.5, 0.5, 0, 0] + list(w2c.reshape(-1))
            f.write(" ".join(str(float(x)) for x in row) + "\n")
    p["pose"] = pose
    p["root"] = str(root)
    return p


def test_exports_match_jax():
    assert pdata.__all__ == jdata.__all__


# ------------------------------------------------------------ CoT triplets

@pytest.mark.parametrize("kw", [
    {},
    {"gradual_ground": True},
    {"gray_viz": "red"},
    {"gray_viz": "black"},
    {"gray_viz": "overlay", "gray_alpha": 0.3},
    {"gradual_ground": True, "gray_viz": "overlay"},
    {"text_drop_ratio": 0.5, "seed": 7},
], ids=["plain", "gradual", "red", "black", "overlay", "gradual-overlay",
        "text-drop"])
def test_cot_triplet_dataset_matches_jax(media, kw):
    """Every item of both datasets, the missing file's included (both retry
    from the same seeded generator), and the CoT pixel layout."""
    args = dict(data_root=media["root"], height=32, width=48,
                source_frames=9, target_frames=9, reasoning_frames=4,
                text_drop_ratio=0.0)
    args.update(kw)
    want_ds = jdataset.CoTTripletDataset(media["json"], **args)
    got_ds = pdataset.CoTTripletDataset(media["json"], **args)
    assert len(got_ds) == len(want_ds) == 3
    for i in (0, 1, 2, 0, 1):
        want, got = want_ds[i], got_ds[i]
        _same(got, want, f"item {i}")
        assert got["pixel_src"].shape == (3, 9, 32, 48)
        _same(got_ds.cot_pixels(got), want_ds.cot_pixels(want))
    if kw.get("text_drop_ratio"):
        texts = [got_ds[0]["text"] for _ in range(8)]
        assert "" in texts and any(texts)


def test_cot_triplet_dataset_gives_up_like_jax(tmp_path):
    jp = str(tmp_path / "bad.json")
    with open(jp, "w") as f:
        json.dump([{"original_video": str(tmp_path / "none.mp4")}], f)
    for mod in (jdataset, pdataset):
        with pytest.raises(RuntimeError, match="too many"):
            mod.CoTTripletDataset(jp, max_retries=3)[0]
        with pytest.raises(ValueError, match="gray_viz"):
            mod.CoTTripletDataset(jp, gray_viz="sparkle")


def test_frame_readers_match_jax(media):
    for path in (media["orig"], media["tall"]):
        assert pdataset._frame_count(path) == jdataset._frame_count(path)
        idx = [0, 5, 3, 11]
        _same(pdataset._read_frames_at(path, idx),
              jdataset._read_frames_at(path, idx))
    for mod in (jdataset, pdataset):
        with pytest.raises(FileNotFoundError):
            mod._read_frames_at(media["root"] + "/none.mp4", [0])


def test_ground_helpers_match_jax():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 255, (4, 24, 32, 3), dtype=np.uint8)
    frames[:, :8, :8] = 120
    src = rng.integers(0, 255, (6, 24, 32, 3), dtype=np.uint8)
    other = rng.integers(0, 255, (16, 20, 3), dtype=np.uint8)
    pairs = [
        (lambda m: m.interpolate_ground_frames(frames[0], frames[1])),
        (lambda m: m.interpolate_ground_frames(frames[0], other,
                                               pick_indices=(0, 5, 15))),
        (lambda m: m.build_gray_mask(frames[0])),
        (lambda m: m.build_gray_mask(frames[0] / 255.0, tolerance=4)),
        (lambda m: m.apply_gray_region_effect(frames, "red")),
        (lambda m: m.apply_gray_region_effect(frames, "black")),
        (lambda m: m.apply_gray_region_effect(frames / 255.0, "red")),
        (lambda m: m.apply_gray_overlay(src, frames, alpha=0.7)),
        (lambda m: m.apply_gray_overlay(src / 255.0, frames, num_frames=2)),
    ]
    for fn in pairs:
        _same(fn(pdataset), fn(jdataset))


# ------------------------------------------------------------------ buckets

def test_buckets_match_jax():
    assert pbuckets.ASPECT_RATIO_512 == jbuckets.ASPECT_RATIO_512
    for hw in ((480, 832), (832, 480), (512, 512), (100, 1000), (37, 91)):
        assert (pbuckets.get_closest_ratio(*hw)
                == jbuckets.get_closest_ratio(*hw))
    rng = np.random.default_rng(1)
    shapes = [tuple(int(v) for v in rng.integers(200, 1200, 2))
              for _ in range(40)]
    for kw in ({"batch_size": 3, "seed": 4},
               {"batch_size": 2, "shuffle": False},
               {"batch_size": 4, "drop_last": True, "seed": 9}):
        assert (list(pbuckets.AspectRatioBatchSampler(shapes, **kw))
                == list(jbuckets.AspectRatioBatchSampler(shapes, **kw)))


@pytest.mark.parametrize("src_hw,out_hw", [
    ((48, 64), (32, 48)),      # downscale: INTER_AREA
    ((48, 64), (96, 80)),      # upscale: INTER_LINEAR
    ((100, 60), (48, 48)),
    ((480, 832), (480, 832)),
])
def test_resize_center_crop_matches_jax(src_hw, out_hw):
    frames = np.random.default_rng(2).integers(
        0, 255, (3, *src_hw, 3), dtype=np.uint8)
    got = pbuckets.resize_center_crop(frames, *out_hw)
    assert got.shape == (3, *out_hw, 3)
    _same(got, jbuckets.resize_center_crop(frames, *out_hw))


# ---------------------------------------------------------- masks, camera

@pytest.mark.parametrize("shape,start_only", [
    ((9, 3, 16, 24), False), ((1, 3, 16, 24), False),
    ((9, 3, 16, 24), True), ((1, 3, 8, 8), True)])
def test_random_masks_match_jax(shape, start_only):
    for seed in range(12):       # enough draws to reach every mode
        _same(pmasks.get_random_mask(shape, start_only,
                                     np.random.default_rng(seed)),
              jmasks.get_random_mask(shape, start_only,
                                     np.random.default_rng(seed)))
        if shape[0] > 1:         # the legacy mask needs two frames
            _same(pdata.legacy_random_mask(shape,
                                           np.random.default_rng(seed)),
                  jdata.legacy_random_mask(shape,
                                           np.random.default_rng(seed)))


def test_camera_matches_jax(media):
    for kw in ({"width": 16, "height": 8}, {"width": 8, "height": 16},
               {"width": 12, "height": 12, "original_pose_width": 640,
                "original_pose_height": 640}):
        _same(pcamera.process_pose_file(media["pose"], **kw),
              jcamera.process_pose_file(media["pose"], **kw))
    rows = pcamera.process_pose_file(media["pose"], return_poses=True)
    assert rows == jcamera.process_pose_file(media["pose"], return_poses=True)
    cams = [pcamera.CameraPose.from_entry(r) for r in rows]
    _same(pcamera.relative_poses(cams), jcamera.relative_poses(
        [jcamera.CameraPose.from_entry(r) for r in rows]))


# -------------------------------------------------------- other datasets

def _annotations(media, tmp_path):
    items = [{"file_path": "orig.mp4", "text": "a clip", "type": "video",
              "control_file_path": "ground.mp4"},
             {"file_path": "still.png", "text": "a still", "type": "image"},
             {"file_path": "tall.mp4", "text": "camera", "type": "video",
              "control_file_path": "pose.txt"},
             {"file_path": "missing.mp4", "text": "x", "type": "video"}]
    jp = str(tmp_path / "ann.json")
    with open(jp, "w") as f:
        json.dump(items, f)
    cp = str(tmp_path / "ann.csv")
    with open(cp, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=["file_path", "text", "type"])
        wr.writeheader()
        wr.writerow({"file_path": "orig.mp4", "text": "a", "type": "video"})
        wr.writerow({"file_path": "still.png", "text": "b", "type": "image"})
    edits = {"v0": {"original_video": "orig.mp4", "edited_video": "edit.mp4",
                    "edit_instruction": "make it red"},
             "v1": {"original_video": "tall.mp4",
                    "edited_video": "orig.mp4",
                    "edit_instruction": "remove it"}}
    ep = str(tmp_path / "edits.json")
    with open(ep, "w") as f:
        json.dump(edits, f)
    return jp, cp, ep


@pytest.mark.parametrize("name", [
    "ImageVideoDataset", "ImageVideoDataset-csv", "ImageVideoControlDataset",
    "VideoEditDataset", "VideoEditReasoningDataset"])
def test_extra_datasets_match_jax(media, tmp_path, name):
    jp, cp, ep = _annotations(media, tmp_path)
    root = media["root"]
    vid = dict(data_root=root, video_sample_size=(32, 48),
               video_sample_stride=2, video_sample_n_frames=5,
               image_sample_size=24, text_drop_ratio=0.3, seed=3)
    args = {
        "ImageVideoDataset": ((jp,), dict(vid, video_repeat=2)),
        "ImageVideoDataset-csv": ((cp,), vid),
        "ImageVideoControlDataset": ((jp,), dict(vid,
                                                 enable_camera_info=True)),
        "VideoEditDataset": ((ep,), dict(data_root=root, height=32, width=48,
                                         source_frames=5, edit_frames=4,
                                         seed=1)),
        "VideoEditReasoningDataset": ((media["json"],), dict(
            data_root=root, height=32, width=48, source_frames=5,
            target_frames=5, reasoning_frames=2)),
    }[name]
    cls = name.split("-")[0]
    want_ds = getattr(jdata, cls)(*args[0], **args[1])
    got_ds = getattr(pdata, cls)(*args[0], **args[1])
    assert len(got_ds) == len(want_ds)
    for i in list(range(len(want_ds))) * 2:
        _same(got_ds[i], want_ds[i], f"{name}[{i}]")


def _legacy_clips(tmp_path):
    root = tmp_path / "clips"
    root.mkdir()
    for name, frames in (("vid0", 24), ("vid1", 6)):
        _write_clip(str(root / f"{name}.mp4"), frames, (48, 64),
                    frames)
    csv_path = str(tmp_path / "webvid.csv")
    with open(csv_path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=["videoid", "name", "page_dir"])
        wr.writeheader()
        wr.writerow({"videoid": "vid0", "name": "a cat", "page_dir": "g0"})
        wr.writerow({"videoid": "vid1", "name": "a dog", "page_dir": "g1"})
        wr.writerow({"videoid": "gone", "name": "x", "page_dir": "g2"})
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for name, hw in (("a", (48, 64)), ("b", (80, 40))):
        cv2.imwrite(str(img_dir / f"{name}.png"), np.random.default_rng(
            hw[0]).integers(0, 255, (*hw, 3), dtype=np.uint8))
    img_json = str(tmp_path / "cc.json")
    with open(img_json, "w") as f:
        json.dump([{"file_path": "a.png", "text": "img a"},
                   {"file_path": "b.png", "text": "img b"},
                   {"file_path": "missing.png", "text": "broken"}], f)
    vid_json = str(tmp_path / "vid.json")
    with open(vid_json, "w") as f:
        json.dump([{"file_path": "vid0.mp4", "text": "hello"},
                   {"file_path": "missing.mp4", "text": "broken"}], f)
    return str(root), csv_path, str(img_dir), img_json, vid_json


@pytest.mark.parametrize("name,kw", [
    ("WebVid10M", dict(sample_size=32, sample_stride=2, sample_n_frames=8)),
    ("WebVid10M", dict(sample_size=32, sample_stride=4, sample_n_frames=16,
                       enable_inpaint=True)),
    ("WebVid10M", dict(sample_size=32, sample_n_frames=4,
                       enable_bucket=True)),
    ("WebVid10M", dict(sample_size=32, is_image=True)),
    ("VideoDataset", dict(sample_size=32, sample_stride=2,
                          sample_n_frames=4, enable_inpaint=True)),
    ("CC15M", dict(resolution=32)),
    ("CC15M", dict(resolution=(32, 48))),
    ("CC15M", dict(resolution=32, enable_bucket=True)),
], ids=["webvid", "webvid-inpaint", "webvid-bucket", "webvid-image",
        "videodataset", "cc15m", "cc15m-tuple", "cc15m-bucket"])
def test_legacy_datasets_match_jax(tmp_path, name, kw):
    clips, csv_path, img_dir, img_json, vid_json = _legacy_clips(tmp_path)
    first = {"WebVid10M": (csv_path, clips), "VideoDataset": (vid_json, clips),
             "CC15M": (img_json, img_dir)}[name]
    want_ds = getattr(jdata, name)(*first, seed=5, **kw)
    got_ds = getattr(pdata, name)(*first, seed=5, **kw)
    assert len(got_ds) == len(want_ds)
    for i in list(range(len(want_ds))) * 2:
        _same(got_ds[i], want_ds[i], f"{name}[{i}]")
