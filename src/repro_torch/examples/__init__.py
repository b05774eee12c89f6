"""The repo's example entry points, on the port.

One module per script of ``examples/``, each run as
``python -m repro_torch.examples.<name>`` with the script's flags and
defaults, printing its lines:

* :mod:`~repro_torch.examples.quickstart` — the six schemes, the
  Section 5 op counts, the single-level window kernel and the batched
  cached engine;
* :mod:`~repro_torch.examples.dwt_image_codec` — a CDF 9/7 codec with a
  PSNR sweep, out-of-core streaming (``--tiles``) and served tiles
  (``--serve``);
* :mod:`~repro_torch.examples.train_lm` — a ~100M-parameter qwen2-family
  model trained for a few hundred steps, optionally with DWT gradient
  compression (``--compress``);
* :mod:`~repro_torch.examples.wavelet_compression_demo` — the
  compression ablation (``none`` / ``dwt:2`` / ``dwt:1``);
* :mod:`~repro_torch.examples.serve_lm` — batched prefill and greedy
  decode with a KV cache.

The work of each sits in functions that return the numbers they print;
every one runs on the card unless the caller passes ``device="cpu"``,
and importing a module does nothing.
"""
