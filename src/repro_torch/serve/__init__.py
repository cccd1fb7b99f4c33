"""Serving surfaces of the port: so far the LM prefill/decode path
(:mod:`repro_torch.serve.lm`)."""
