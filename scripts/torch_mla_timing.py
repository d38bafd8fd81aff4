"""Device time of flash attention's MLA paths at deepseek-v3-671b's TP 8
serve shapes, on the card: the prefill (q ``[32, 1024, 1, 16, 576]``,
causal; ``"mla_wgmma"``) and the decode (``"mla"``) at kv_len 1025 and 1056 in a 2048-slot
latent cache, the keys contiguous or a view of the serve's joint cache
buffer ``[8, 4, 2048, 576]``, with the L2 cache warm (the same keys
launch after launch) or flushed before each launch (a 128 MB write: the
served decode finds its latent cold, the expert layers between two
layers' decodes streaming GBs of weights).
Each time is the kernel's device time from ``torch.profiler`` (mean of
20 launches); the card's name and power limit first.

    python scripts/torch_mla_timing.py
"""
import math
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels.variants import device_ms  # noqa: E402


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    scale = 1.0 / math.sqrt(192)
    flush = torch.zeros(32 << 20, device=dev)          # 128 MB
    q = torch.randn(32, 1024, 1, 16, 576, generator=g, device=dev).bfloat16()
    k = torch.randn(32, 1024, 1, 576, generator=g, device=dev).bfloat16()
    ms = device_ms(lambda: fa.flash_attention(q, k, k[..., :512],
                                              scale=scale), "fa_mla")
    print(f"mla prefill [32, 1024, 1, 16, 576]: {ms:.4f} ms "
          f"({5.847e11 / ms / 1e9:.1f} TFLOP/s)")
    q1 = torch.randn(32, 1, 1, 16, 576, generator=g, device=dev).bfloat16()
    kc = torch.randn(32, 2048, 1, 576, generator=g, device=dev).bfloat16()
    joint = torch.randn(8, 4, 2048, 576, generator=g, device=dev).bfloat16()
    for kv_len in (1025, 1056):
        kw = dict(q0=kv_len - 1, kv_len=kv_len, scale=scale)
        view = joint[:, :, :kv_len].flatten(0, 1)[:, :, None, :]
        for label, keys in (("contiguous", kc), ("cache view", view)):
            for warm in (True, False):
                def call(keys=keys, warm=warm):
                    if not warm:
                        flush.add_(1)
                    return fa.flash_attention(q1, keys, keys[..., :512],
                                              **kw)
                ms = device_ms(call, "fa_mla")
                mb = 32 * kv_len * 576 * 2 / 1e6
                print(f"mla decode kv_len {kv_len} {label}, L2 "
                      f"{'warm' if warm else 'flushed'}: {ms:.4f} ms "
                      f"({mb / ms:.1f} GB/s over {mb:.1f} MB)")
    print(f"launches by path: {fa.flash_attention.launches_by_path}")


if __name__ == "__main__":
    main()
