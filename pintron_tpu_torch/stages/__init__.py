"""Pipeline stages whose device flow the port owns: STEP 2 (est-fact)
and STEP 4 (intron agreement)."""
