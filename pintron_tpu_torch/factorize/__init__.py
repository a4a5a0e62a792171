"""Device call sites of ``pintron_tpu.factorize`` that the port owns
(the stage-4 branch-point sweep, ``classify``)."""
