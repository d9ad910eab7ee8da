"""The benchmark of torch_nfft_tpu_torch on an NVIDIA H100.

``nfft_bench/run.py`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, traffic mix, metric or cell is a file of its
own under ``nfft_bench/``, found by the name that ``BENCHMARK.json`` gives
(:mod:`nfftb.spec`); this package is the general machinery around them.
"""
