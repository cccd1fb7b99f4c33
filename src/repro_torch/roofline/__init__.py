"""``repro_torch.roofline`` — the card's peaks and the roofline terms
(counterpart of ``repro.roofline``; only what the autotuner's cost model
and ``chip_smoke.py``'s bounds need so far)."""
