"""Host-side data helpers of the port (own copies; no reference imports)."""

from .vocab import PAD_EOS, Vocab

__all__ = ["PAD_EOS", "Vocab"]
