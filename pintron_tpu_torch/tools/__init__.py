"""Standard-library tools of the port: the synthetic locus generator
(``scale_stress.make_case``) that the device fuzz and the bench's
stress channel share."""
