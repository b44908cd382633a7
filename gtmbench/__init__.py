"""gtmbench: the benchmark of tiler_tpu_torch, the PyTorch and CUDA port of
the GTM encoder, on NVIDIA H100 cards. BENCHMARK.json at the repository
root names its cells; run.py runs one (`python3 -m gtmbench --help`).

It imports the port (tiler_tpu_torch) as the system under test and reads
its step times, counters and kernel names. Its yardstick is its own and
imports nothing of the port: the clips (traffic/generators.py), the
decoder and PSNR (reference/gtm.py), the 1-NN reference and its TF32
control (reference/nn.py), the trace reduction (trace.py) and the
per-layer readers (metrics/)."""
