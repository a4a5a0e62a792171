"""The factorization code of STEP 2 and the intron classifier of STEP 4:
the port's copies of ``pintron_tpu.factorize``, with the branch-point
sweep of ``classify`` on the port's device."""
