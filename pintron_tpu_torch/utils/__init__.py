"""Shared host-side utilities (reference: src/util.c, src/log.c)."""

from pintron_tpu_torch.utils.fsio import write_text  # noqa: F401
