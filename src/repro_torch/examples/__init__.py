"""The reference's four examples on the port, each run as
``python -m repro_torch.examples.<name> [--device cuda|cpu]`` and each a
``main(device=...)`` that prints the reference script's lines and returns
the numbers it prints:

  * ``quickstart``: SKIP on a reduced GPT-2 (trace, measured host
    dispatch, the three platforms, the inflection, chain mining, fusion);
  * ``serve_continuous_batching``: the continuous-batching engine over
    reduced SmolLM-360M;
  * ``platform_characterization``: TTFT against batch on the LC and CC
    platform models, their crossover and the fusion opportunity;
  * ``train_fault_tolerant``: checkpoints, a simulated crash and the
    exact resume.
"""
