"""Dataset parsers producing device-ready view batches.

Covers the reference's two parser families (reference:
edgegaussians/data/dataparsers.py):

- :class:`EMAPParser` — ``meta_data.json`` with per-frame ``rgb_path``,
  ``camtoworld``, ``intrinsics`` (dataparsers.py:96-127), used for
  ABC-NEF / Replica / DTU-EMAP layouts.
- :class:`ColmapParser` — COLMAP ``cameras``/``images`` .txt/.bin with
  SIMPLE_PINHOLE / PINHOLE models (dataparsers.py:38-93).

Unlike the reference (a Python list of per-view dicts consumed one view at a
time), parsing here ends in :class:`SceneViews` — stacked ``[V,H,W]`` image
and ``[V,...]`` camera arrays, the static-shape batch the jitted train
step consumes directly.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

from edgegaussians_tpu.cameras import Camera, stack_cameras
from edgegaussians_tpu.io import colmap as colmap_io, png


@dataclass
class SceneViews:
    """A full scene's views as stacked arrays (the device data contract)."""

    images: np.ndarray     # [V,H,W] float32 in [0,1] (edge intensity)
    Ks: np.ndarray         # [V,3,3] float32
    viewmats: np.ndarray   # [V,4,4] float32 world->camera
    height: int
    width: int
    cameras: List[Camera]  # host-side camera records (extraction / filtering)

    @property
    def num_views(self) -> int:
        return self.images.shape[0]

    def scale_translations(self, factor: float) -> "SceneViews":
        """Scene-unit rescale of all camera translations
        (reference: train_gaussians.py:283-284)."""
        cams = [c.scale_translation(factor) for c in self.cameras]
        Ks, viewmats, h, w = stack_cameras(cams)
        return SceneViews(images=self.images, Ks=Ks, viewmats=viewmats,
                          height=h, width=w, cameras=cams)


def load_image_grayscale(image_dir: str, image_name: str) -> np.ndarray:
    """Load one edge map as float32 [H,W] in [0,255].

    Mirrors the reference's extension-fallback behavior
    (dataparsers.py:19-35): if a .jpg name is missing, try .png/.PNG.
    Multi-channel inputs are reduced to luminance (the reference keeps the
    raw array and later slices channel 0 of the render —
    train_gaussians.py:84; detector outputs are single-channel in practice).
    """
    path = Path(image_dir) / image_name
    if not path.exists():
        if path.suffix.lower() in (".jpg", ".jpeg"):
            stem = image_name.split(".")[0]
            for ext in (".png", ".PNG"):
                cand = Path(image_dir) / (stem + ext)
                if cand.exists():
                    path = cand
                    break
        if not path.exists():
            raise FileNotFoundError(f"Image file not found: {path}")
    return png.to_gray(png.read_png(path)).astype(np.float32)


class EMAPParser:
    """Parser for EMAP-style ``meta_data.json`` scenes
    (reference: dataparsers.py:96-127)."""

    def __init__(self, meta_file_path: str):
        self.meta_file_path = Path(meta_file_path)

    def load_views(self, images_dir: str) -> SceneViews:
        with open(self.meta_file_path, "r") as f:
            meta = json.load(f)
        height, width = meta["height"], meta["width"]

        cameras, images = [], []
        for frame in meta["frames"]:
            cam = Camera.from_camtoworld(
                height, width,
                K=np.array(frame["intrinsics"]),
                camtoworld=np.array(frame["camtoworld"]))
            cameras.append(cam)
            images.append(load_image_grayscale(images_dir, frame["rgb_path"]))

        Ks, viewmats, h, w = stack_cameras(cameras)
        return SceneViews(
            images=np.stack(images) / 255.0,
            Ks=Ks, viewmats=viewmats, height=h, width=w, cameras=cameras)


class ColmapParser:
    """Parser for COLMAP sparse models (reference: dataparsers.py:38-93)."""

    def __init__(self, base_path: str, new_extension: Optional[str] = None):
        self.base_path = Path(base_path)
        self.new_extension = new_extension

    def _find(self, stem: str) -> Path:
        for ext in (".txt", ".bin"):
            p = self.base_path / (stem + ext)
            if p.exists():
                return p
        raise FileNotFoundError(f"{stem}.txt/.bin not found in {self.base_path}")

    def load_views(self, images_dir: str,
                   image_res_scaling_factor: float = 1.0) -> SceneViews:
        cam_path = self._find("cameras")
        img_path = self._find("images")
        colmap_cameras = (colmap_io.read_cameras_text(cam_path)
                          if cam_path.suffix == ".txt"
                          else colmap_io.read_cameras_binary(cam_path))
        colmap_images = (colmap_io.read_images_text(img_path)
                         if img_path.suffix == ".txt"
                         else colmap_io.read_images_binary(img_path))

        cameras, images = [], []
        for im_id in colmap_images:
            im = colmap_images[im_id]
            ccam = colmap_cameras[im.camera_id]
            if ccam.model == "SIMPLE_PINHOLE":
                fx = fy = ccam.params[0]
                cx, cy = ccam.params[1], ccam.params[2]
            elif ccam.model == "PINHOLE":
                # NOTE: the reference passes params[0..3] as (fx, fy, cx, cy)
                # positionally even for SIMPLE_PINHOLE (dataparsers.py:81) —
                # we decode each model correctly.
                fx, fy, cx, cy = ccam.params[:4]
            else:
                raise ValueError(
                    f"Unsupported COLMAP camera model {ccam.model}; only "
                    "SIMPLE_PINHOLE/PINHOLE are supported (as in the reference)")
            cam = Camera.from_colmap(
                ccam.height, ccam.width, fx, fy, cx, cy,
                im.qvec, im.tvec, scaling_factor=image_res_scaling_factor)
            cameras.append(cam)

            if self.new_extension is not None and self.new_extension != "":
                stem = ".".join(im.name.split(".")[:-1])
                image_name = stem + self.new_extension
            else:
                image_name = im.name
            images.append(load_image_grayscale(images_dir, image_name))

        Ks, viewmats, h, w = stack_cameras(cameras)
        return SceneViews(
            images=np.stack(images) / 255.0,
            Ks=Ks, viewmats=viewmats, height=h, width=w, cameras=cameras)


def get_parser(parser_type: str, input_path: str, new_extension=None):
    """Parser factory (reference: dataparsers.py:129-138)."""
    if parser_type == "colmap":
        return ColmapParser(base_path=input_path, new_extension=new_extension)
    if parser_type == "emap":
        return EMAPParser(meta_file_path=input_path)
    raise ValueError(f"Unsupported parser type: {parser_type}")


def get_paths_from_data_config(data_config, scene_name: str):
    """Per-dataset path layout (reference: parse_utils.py:20-63).

    Returns (images_dir, parser_input_path, seed_points_path).
    """
    if data_config.parser_type == "emap":
        data_dir = Path(data_config.base_dir) / scene_name
        cameras_path = data_dir / "meta_data.json"
        images_dir = data_dir / f"edge_{data_config.edge_detection_method}"
        if data_config.dataset_name in ("ABC", "Replica", "tnt"):
            seed_path = data_dir / "colmap/sparse/sparse.ply"
        elif data_config.dataset_name == "DTU":
            seed_path = data_dir / "sparse_sfm_points.txt"
        else:
            seed_path = data_dir / "colmap/sparse/sparse.ply"
        return str(images_dir), str(cameras_path), str(seed_path)

    if data_config.parser_type == "colmap":
        data_dir = Path(data_config.base_dir) / scene_name
        images_dir = data_dir / f"edge_{data_config.edge_detection_method}"
        colmap_base = data_dir / "colmap"
        seed_path = None
        for cand in ("sparse.ply", "points3D.bin", "points3D.txt"):
            if (colmap_base / cand).exists():
                seed_path = str(colmap_base / cand)
                break
        return str(images_dir), str(colmap_base), seed_path

    raise ValueError(f"Unsupported parser type: {data_config.parser_type}")


def load_scene(data_config, scene_name: str) -> SceneViews:
    """Resolve paths, build the parser, and load all views."""
    images_dir, input_path, _ = get_paths_from_data_config(data_config, scene_name)
    parser = get_parser(data_config.parser_type, input_path,
                        new_extension=data_config.new_extension)
    if data_config.parser_type == "colmap":
        return parser.load_views(
            images_dir,
            image_res_scaling_factor=data_config.image_res_scaling_factor or 1.0)
    return parser.load_views(images_dir)
