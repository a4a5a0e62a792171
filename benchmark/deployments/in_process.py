"""The port's CLI path in one process: ``pintron_pipeline`` with the
card in this process and no device service, as ``python -m
pintron_tpu_torch.pipeline --device cuda`` runs one gene a call."""

from __future__ import annotations

import os

from benchmark.harness import trace


class Deployment:
    def __init__(self, device: str, fault: str = None):
        self.device = device
        self.fault = fault
        self._trace = None
        self._undo = None

    def start(self) -> None:
        os.environ.pop("PINTRON_TORCH_SERVICE", None)
        if self.fault:
            from benchmark.harness import faults
            if self.fault in faults.CLIENT_FAULTS:
                self._undo = faults.plant_client(self.fault)
            else:
                from pintron_tpu_torch.ops import offload
                self._undo = faults.plant(offload, self.fault)

    def trace_start(self) -> None:
        self._trace = trace.start()

    def trace_stop(self) -> dict:
        return trace.stop(self._trace)

    def report(self) -> dict:
        """The card's name and memory peak; ``forbidden`` is empty, since
        the process that owns the card is the one that prints the
        result, whose modules the command line checks."""
        import torch
        dev = torch.device(self.device)
        if dev.type != "cuda":
            return {"kind": "cpu", "memory_peak_bytes": 0, "evals": None,
                    "forbidden": []}
        return {"kind": torch.cuda.get_device_name(dev),
                "memory_peak_bytes": torch.cuda.max_memory_allocated(dev),
                "evals": None, "forbidden": []}

    def stop(self) -> None:
        if self._undo:
            self._undo()
            self._undo = None


def make(config: dict, traffic: dict, device: str, root: str,
         fault: str = None):
    return Deployment(device, fault)
