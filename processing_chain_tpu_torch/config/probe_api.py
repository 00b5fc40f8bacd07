"""Prober interface between the config layer and the media I/O layer
(copy of processing_chain_tpu/config/probe_api.py).

The reference probes SRCs with ffprobe subprocesses during YAML parsing
(test_config.py:1444-1445 → ffmpeg.get_src_info :566-633, with .yaml sidecar
caching). Here probing is an injected interface so the domain model is
testable without media files, and the real implementation (io/probe.py) uses
the native libav boundary instead of a subprocess.
"""

from __future__ import annotations

from typing import Optional, Protocol


class SrcProber(Protocol):
    def src_info(self, file_path: str, sidecar_path: Optional[str] = None) -> dict:
        """Stream info for a SRC: at least width, height, pix_fmt,
        r_frame_rate, video_duration. Cached in a .yaml sidecar when
        sidecar_path is given (reference ffmpeg.py:604-632)."""
        ...

    def duration(self, file_path: str, sidecar_path: Optional[str] = None) -> float:
        """Video duration in seconds (reference ffmpeg.py get_segment_info
        'video_duration')."""
        ...


class StaticProber:
    """In-memory prober for tests and dry runs: {path or basename: info dict}.

    Each info dict needs width/height/pix_fmt/r_frame_rate/video_duration.
    """

    def __init__(self, table: dict[str, dict], default: Optional[dict] = None) -> None:
        self.table = table
        self.default = default

    def _lookup(self, file_path: str) -> dict:
        import os

        info = self.table.get(file_path) or self.table.get(os.path.basename(file_path))
        if info is None:
            if self.default is not None:
                return self.default
            raise KeyError(f"StaticProber has no info for {file_path}")
        return info

    def src_info(self, file_path: str, sidecar_path: Optional[str] = None) -> dict:
        return self._lookup(file_path)

    def duration(self, file_path: str, sidecar_path: Optional[str] = None) -> float:
        return float(self._lookup(file_path)["video_duration"])


def default_prober() -> SrcProber:
    """The real prober backed by the port's libav boundary."""
    from ..io import probe

    return probe.LibavProber()
