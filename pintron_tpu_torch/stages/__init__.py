"""The pipeline's stages: the port's copies of ``pintron_tpu.stages``,
with the device flows of STEP 2 (est-fact) and STEP 4 (intron
agreement) on a torch device."""
