"""The batched scoring step (``mesh.alignment_step``) on one device.
The step sharded over several devices and processes comes later
(ROADMAP A3)."""
