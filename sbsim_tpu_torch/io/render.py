"""Building visualization: temperature heatmaps and episode animations.

Equivalent of the reference's PIL renderer + visual logger
(building_renderer.py:34-297, visual_logger.py:25-99): paint the temperature
field as a color map with walls masked, accumulate frames over an episode,
export an animation. Port of sbsim_tpu/io/render.py: the frames are numpy
arrays; single frames are PNG from a small zlib writer (`encode_png`), so
they need no imaging library; a PIL Image and the GIF animation need
Pillow, imported when asked for.
"""

from __future__ import annotations

import base64
import struct
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sbsim_tpu_torch.utils import telemetry

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _pil_image():
    """PIL's Image module; RuntimeError without Pillow."""
    try:
        from PIL import Image
    except ImportError as err:
        raise RuntimeError("Pillow is not available") from err
    return Image


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as PNG bytes: 8-bit RGB, no interlace, each
    scanline with filter type 0 (none), one zlib stream."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes an (H, W, 3) image; got shape {rgb.shape}")
    height, width = rgb.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8), rgb.reshape(height, -1)], axis=1)
    header = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + _png_chunk(b"IEND", b""))


def _colormap(values01: np.ndarray) -> np.ndarray:
    """Simple blue->cyan->yellow->red map, uint8 (H, W, 3)."""
    v = np.clip(values01, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * v - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * v - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * v - 1.0), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


class BuildingRenderer:
    """Renders temperature arrays over a wall mask."""

    def __init__(
        self,
        wall_mask: np.ndarray,
        cv_px: int = 4,
        vmin: float = 280.0,
        vmax: float = 300.0,
    ):
        """Args:
        wall_mask: bool/int (H, W), nonzero marks wall CVs drawn black.
        cv_px: pixels per control volume.
        vmin/vmax: color scale bounds in K.
        """
        self._wall_mask = np.asarray(wall_mask) != 0
        self._cv_px = cv_px
        self._vmin = vmin
        self._vmax = vmax

    def render_array(
        self,
        temps: np.ndarray,
        diffusers: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Returns an RGB uint8 image of the temperature field."""
        t = (np.asarray(temps, float) - self._vmin) / (
            self._vmax - self._vmin
        )
        rgb = _colormap(t)
        rgb[self._wall_mask] = 0
        if diffusers is not None:
            rgb[np.asarray(diffusers) > 0] = (255, 255, 255)
        if self._cv_px > 1:
            rgb = np.repeat(
                np.repeat(rgb, self._cv_px, axis=0), self._cv_px, axis=1
            )
        return rgb

    def render(self, temps: np.ndarray, **kwargs):
        """Returns a PIL Image (requires Pillow)."""
        return _pil_image().fromarray(self.render_array(temps, **kwargs))

    def get_building_dimensions(self) -> Tuple[int, int]:
        h, w = self._wall_mask.shape
        return h * self._cv_px, w * self._cv_px


class VisualLogger:
    """Accumulates per-step temperature frames; exports a GIF animation
    (visual_logger.py:25-99 equivalent)."""

    def __init__(self, renderer: BuildingRenderer, max_frames: int = 5000):
        self._renderer = renderer
        self._frames: List[np.ndarray] = []
        self._max_frames = max_frames

    def log(self, temps: np.ndarray) -> None:
        if len(self._frames) < self._max_frames:
            self._frames.append(np.array(temps, copy=True))

    @property
    def n_frames(self) -> int:
        return len(self._frames)

    def get_video(
        self, file_path: str, fps: int = 12, stride: int = 1
    ) -> None:
        """Writes an animated GIF of the logged frames (requires Pillow)."""
        Image = _pil_image()
        if not self._frames:
            raise ValueError("No frames logged")
        images = [
            Image.fromarray(self._renderer.render_array(f))
            for f in self._frames[::stride]
        ]
        images[0].save(
            file_path,
            save_all=True,
            append_images=images[1:],
            duration=int(1000 / fps),
            loop=0,
        )

    def clear(self) -> None:
        self._frames = []


class BuildingImageGenerator:
    """ObservationResponse -> base64 PNG of zone temperatures painted onto
    the floor plan (building_image_generator.py:51-125 and
    real_building_temperature_array_generator.py:29-82 equivalents).

    Requires a device->zone layout: device_id -> zone index grid id.
    """

    def __init__(
        self,
        zone_ids_grid: np.ndarray,
        zone_ext_ids: Sequence[str],
        wall_mask: Optional[np.ndarray] = None,
        device_to_zone_id: Optional[dict] = None,
        cv_px: int = 4,
        vmin: float = 285.0,
        vmax: float = 303.0,
    ):
        self._zone_ids_grid = np.asarray(zone_ids_grid)
        self._zone_ext_ids = list(zone_ext_ids)
        self._device_to_zone_id = device_to_zone_id or {}
        walls = (
            wall_mask
            if wall_mask is not None
            else np.zeros(self._zone_ids_grid.shape, bool)
        )
        self._renderer = BuildingRenderer(walls, cv_px, vmin, vmax)

    def temperature_array(self, observation_response) -> np.ndarray:
        """Paints each VAV's zone_air_temperature_sensor into its zone."""
        zone_values = {}
        for single in observation_response.single_observation_responses:
            request = single.single_observation_request
            if (
                request.measurement_name != "zone_air_temperature_sensor"
                or not single.observation_valid
            ):
                continue
            zone_id = self._device_to_zone_id.get(request.device_id)
            if zone_id is None and request.device_id.startswith("vav_room_"):
                zone_id = "zone_id_" + request.device_id[len("vav_room_"):]
            if zone_id is not None:
                zone_values[zone_id] = single.continuous_value
        return telemetry.paint_zone_temperatures(
            zone_values, self._zone_ids_grid, self._zone_ext_ids,
            fill_value=self._renderer._vmin,
        )

    def generate_building_image(self, observation_response) -> bytes:
        """Returns the rendered frame as base64-encoded PNG bytes."""
        array = self.temperature_array(observation_response)
        return base64.b64encode(encode_png(self._renderer.render_array(array)))
