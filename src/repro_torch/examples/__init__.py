"""Twins of the JAX package's five examples (``examples/*.py``).

Each module runs as ``python -m repro_torch.examples.<name>``, takes the
JAX example's arguments and defaults plus ``--device`` (the card, ``cuda``,
by default; a host without CUDA raises unless ``--device cpu`` is given)
and prints the JAX example's lines.  ``main(argv)`` returns what it
printed as numbers, for callers that check them:

* ``quickstart``          — PSSA compression, TIPS spotting through the
                            cross-attention kernel, DBSC through the
                            bit-slice kernel against its integer oracle;
* ``tips_visualization``  — the TIPS importance map of a synthetic
                            cross-attention field;
* ``generate_image``      — text-to-image through ``DiffusionEngine`` (or
                            ``StableDiffusionPipeline``) and the energy
                            ledger, at BK-SDM-Tiny's full width unless
                            ``--smoke``;
* ``serve_lm``            — prefill and greedy decode of a smoke-geometry
                            LM, and one DBSC FFN tile;
* ``train_lm``            — a ~100M-parameter llama through ``Trainer``,
                            resumable from its checkpoints.

A file a JAX example writes under ``/tmp`` goes to a path of the twin's
own under ``tempfile.gettempdir()``.
"""
