"""GIF / MP4 muxing of saved frame directories, a copy of
``cgd_tpu/io_utils/video.py`` (the reference's ``cgd/script_util.py:104-214``):
frame glob ``<slug>/<batch:02>/*.png``, palettegen / paletteuse GIF with
floyd_steinberg dithering, x264 crf18 slow MP4 with +faststart, optional
frame deletion.

The ``ffmpeg`` binary is used when it is on the PATH. Without it the
in-process encoders are tried, each only when importable: Pillow's animated
GIF writer and OpenCV's VideoWriter (mp4v). With neither the function says
so and returns ``None``; nothing is installed or fetched.
"""

from __future__ import annotations

import glob
import os
import subprocess
from typing import List, Optional

from cgd_tpu_torch.io_utils.images import clean_and_combine_prompts


def _frames(base, prompts, batch_idx):
    d = clean_and_combine_prompts(base, prompts, batch_idx)
    return d, sorted(glob.glob(os.path.join(d, "*.png")))


def _cleanup(dirname: str, files: List[str]):
    for f in files:
        os.remove(f)
    if os.path.isdir(dirname) and not os.listdir(dirname):
        os.rmdir(dirname)
    print(f"Deleted {len(files)} frame(s)")


def _gif_fallback(files: List[str], gif: str, fps: int) -> Optional[str]:
    """Animated GIF via PIL when the ffmpeg binary is unavailable."""
    try:
        from PIL import Image
    except ImportError:
        return None
    frames = [Image.open(f).convert("RGB").quantize(colors=256) for f in files]
    frames[0].save(
        gif, save_all=True, append_images=frames[1:],
        duration=max(1, round(1000 / fps)), loop=0,
    )
    return gif


def _mp4_fallback(files: List[str], mp4: str, fps: int) -> Optional[str]:
    """MP4 via OpenCV's bundled FFMPEG (mp4v) when the binary is missing."""
    try:
        import cv2
    except ImportError:
        return None
    first = cv2.imread(files[0])
    if first is None:
        return None
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not writer.isOpened():
        return None
    try:
        for f in files:
            writer.write(cv2.imread(f))
    finally:
        writer.release()
    return mp4


def create_gif_ffmpeg(base, prompts, batch_idx, fps: int = 10, delete_frames: bool = False) -> Optional[str]:
    dirname, files = _frames(base, prompts, batch_idx)
    if not files:
        print(f"No images found in {dirname}")
        return None
    gif = f"{dirname}_{batch_idx:02}.gif"
    palette = os.path.join(dirname, "palette.png")
    pattern = os.path.join(dirname, "%04d.png")
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i", pattern,
             "-vf", "palettegen=max_colors=256:stats_mode=full", palette],
            check=True, capture_output=True,
        )
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i", pattern, "-i", palette,
             "-lavfi", "paletteuse=dither=floyd_steinberg:bayer_scale=5:diff_mode=rectangle",
             "-loop", "0", gif],
            check=True, capture_output=True,
        )
        print(f"Created GIF: {gif}")
        if os.path.exists(palette):
            os.remove(palette)
        if delete_frames:
            _cleanup(dirname, files)
        return gif
    except subprocess.CalledProcessError as e:
        print(f"ffmpeg error: {e.stderr.decode() if e.stderr else e}")
        return None
    except FileNotFoundError:
        out = _gif_fallback(files, gif, fps)
        if out is None:
            print("ffmpeg not found. Please install ffmpeg to use this feature.")
            return None
        print(f"Created GIF (PIL fallback, no ffmpeg binary): {out}")
        if delete_frames:
            _cleanup(dirname, files)
        return out


def create_video_ffmpeg(base, prompts, batch_idx, fps: int = 10, delete_frames: bool = False) -> Optional[str]:
    dirname, files = _frames(base, prompts, batch_idx)
    if not files:
        print(f"No images found in {dirname}")
        return None
    mp4 = f"{dirname}_{batch_idx:02}.mp4"
    pattern = os.path.join(dirname, "%04d.png")
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i", pattern,
             "-c:v", "libx264", "-preset", "slow", "-crf", "18",
             "-pix_fmt", "yuv420p", "-movflags", "+faststart", mp4],
            check=True, capture_output=True,
        )
        print(f"Created video: {mp4}")
        if delete_frames:
            _cleanup(dirname, files)
        return mp4
    except subprocess.CalledProcessError as e:
        print(f"ffmpeg error: {e.stderr.decode() if e.stderr else e}")
        return None
    except FileNotFoundError:
        out = _mp4_fallback(files, mp4, fps)
        if out is None:
            print("ffmpeg not found. Please install ffmpeg to use this feature.")
            return None
        print(f"Created video (OpenCV mp4v fallback, no ffmpeg binary): {out}")
        if delete_frames:
            _cleanup(dirname, files)
        return out
