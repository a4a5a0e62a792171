"""Standard-library tools of the port: the synthetic locus generator
(``scale_stress.make_case``) that the device fuzz and the bench's
stress channel share, and the test-data generator
(``test_data_create``, a rebuild of the reference's
src/test-data-create.c)."""
