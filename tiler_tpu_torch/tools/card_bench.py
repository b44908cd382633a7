"""Two measurements of the card behind the design of csrc/nn1.cu:

    python -m tiler_tpu_torch.tools.card_bench

Builds csrc/card_bench.cu with nvcc into build/tiler_tpu_torch/ and runs
it: cycles per warp-wide shared-memory load by width and lane pattern,
and the FP32 rate of 8 x 8 outer-product FFMAs from registers alone.
Prints the program's lines after the card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys

from ..ops import nn_kernels as nk
from .common import card_line


def main() -> int:
    src = os.path.join(os.path.dirname(nk.SOURCES['nn1']), 'card_bench.cu')
    exe = os.path.join(nk.BUILD_DIR, 'card_bench')
    os.makedirs(nk.BUILD_DIR, exist_ok=True)
    subprocess.run([nk._nvcc(), '-gencode', 'arch=compute_90a,code=sm_90a',
                    '-std=c++17', '-O3', '-o', exe, src], check=True)
    print(card_line('cuda'), flush=True)
    return subprocess.run([exe], timeout=600).returncode


if __name__ == '__main__':
    sys.exit(main())
