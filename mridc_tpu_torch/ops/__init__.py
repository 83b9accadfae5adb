"""Complex algebra on real views (:mod:`.cplx`) and FFTs (:mod:`.fft`)."""
