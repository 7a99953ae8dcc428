"""Captioning model of the port: the attention-LSTM and Transformer
decoders over temporal or modality fusion."""

from .captioner import CaptionModel, shift_right

__all__ = ["CaptionModel", "shift_right"]
