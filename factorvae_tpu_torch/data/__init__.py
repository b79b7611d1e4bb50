"""Panels, look-back windows, the dataset and its residencies, the stream
of chunks and the append-only panel store (`factorvae_tpu/data/`)."""

from factorvae_tpu_torch.data.append import AppendError, PanelStore  # noqa: F401
