"""Captioning model of the port (LSTM decoder, temporal fusion)."""

from .captioner import CaptionModel, shift_right

__all__ = ["CaptionModel", "shift_right"]
