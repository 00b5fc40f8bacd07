"""Database domain objects the port needs so far (trimmed copy of
processing_chain_tpu/config/domain.py and config/errors.py): the
viewing-context render target of the CPVS transforms. The YAML
database, `Pvs` and the test config are not ported yet."""

from __future__ import annotations


class ConfigError(ValueError):
    """A database YAML (or its environment) violates a chain invariant."""


class PostProcessing:
    """A viewing-context render target for CPVS (reference
    lib/test_config.py:947-979), built from its YAML mapping. The
    reference's back-reference to its test config is left out."""

    TYPES = ("pc", "tablet", "mobile", "hd-pc-home", "uhd-pc-home")

    def __init__(self, data: dict) -> None:
        self.processing_type = data["type"]
        if self.processing_type not in self.TYPES:
            raise ConfigError(
                f"Wrong post processing type {self.processing_type!r}, must be "
                f"one of {self.TYPES}"
            )
        try:
            self.display_width = int(data["displayWidth"])
            self.display_height = int(data["displayHeight"])
            self.coding_width = int(data["codingWidth"])
            self.coding_height = int(data["codingHeight"])
        except (KeyError, TypeError, ValueError) as exc:
            raise ConfigError(f"Missing or wrong data in post processing: {exc}") from exc

        if self.display_width != self.coding_width:
            raise ConfigError("Post processing must have same coding and display width")
        if self.processing_type == "pc" and (
            self.display_height != self.coding_height
            or self.display_width != self.coding_width
        ):
            raise ConfigError(
                "PC post processing must have same coding and display width/height"
            )
        self.display_frame_rate = data.get("displayFrameRate", 60)

    def __repr__(self) -> str:
        return f"<PostProcessing {self.processing_type.upper()}>"
