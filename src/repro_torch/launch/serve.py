"""Batched serving driver: prefill a prompt batch, then decode tokens.

Port of ``src/repro/launch/serve.py``: the same flags, plus ``--device``
(default ``cuda``, which raises without a card; ``cpu`` runs every
kernel's plain version on the host).  Weights are random, drawn on the
device from ``--seed``; so are the prompts: token ids, or for a
stub-frontend arch (VLM) the frontend's embeddings.  :func:`generate` is
the greedy prefill + decode loop for every causal family; on a card each
decode step runs kernel 2 once per attention layer: every layer of a
transformer, every shared-attention site of Zamba2, none in RWKV6.

Usage:
  python -m repro_torch.launch.serve --arch llama3.2-3b --smoke --device cpu
  python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke --device cpu
  python -m repro_torch.launch.serve --arch llama3.2-3b --batch 4 \\
      --prompt-len 512 --gen 32
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --batch 4 \\
      --prompt-len 512 --gen 32
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.runtime import resolve_device
from repro_torch.models import get_model


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mallocs(dev: torch.device) -> int:
    return torch.cuda.memory_stats(dev).get("num_device_alloc", 0)


def generate(model, prompts: torch.Tensor, gen: int) -> dict:
    """Greedy serving of ``prompts`` ((B, S) token ids, or (B, S, D)
    embeddings for a stub-frontend arch): prefill with room for ``gen``
    tokens, then ``gen - 1`` decode steps, each fed the last argmax.

    Returns ``tokens`` (B, gen), the last ``logits`` and ``cache``,
    ``prefill_s`` and ``decode_s`` (host clock around work that ends in a
    device synchronise) and, on a card, ``decode_mallocs``: the
    allocator's cudaMalloc calls during the decode loop.
    """
    dev = model.device
    S = prompts.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = model.prefill(prompts, max_len=S + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    tok = logits.argmax(-1)
    out = [tok]
    mallocs = _mallocs(dev) if dev.type == "cuda" else None
    t0 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = model.decode(cache, tok)
        tok = logits.argmax(-1)
        out.append(tok)
    _sync(dev)
    res = {"tokens": torch.stack(out, dim=1), "logits": logits,
           "cache": cache, "prefill_s": t_prefill,
           "decode_s": time.perf_counter() - t0}
    if mallocs is not None:
        res["decode_mallocs"] = _mallocs(dev) - mallocs
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--greedy", action="store_true",
                    help="accepted as the reference's serve takes it; has "
                         "no effect: decoding is always greedy")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if not cfg.causal:
        raise SystemExit(f"{cfg.name} is encoder-only: no decode serving")

    dev = resolve_device(args.device, "--device")
    rng = torch.Generator(device=dev).manual_seed(args.seed)
    model = get_model(cfg, device=dev).init(rng)
    B, P = args.batch, args.prompt_len
    if cfg.embedding_input:
        prompts = torch.randn((B, P, cfg.d_model), generator=rng,
                              device=dev).to(cfg.adtype)
    else:
        prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=rng,
                                device=dev)

    res = generate(model, prompts, args.gen)
    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    gen = res["tokens"].cpu().numpy()
    tput = B * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"[serve] arch={cfg.name} batch={B} prompt={P} gen={args.gen} "
          f"device={dev}")
    print(f"  prefill {t_prefill*1e3:.1f} ms   decode {t_decode*1e3:.1f} ms "
          f"({tput:.1f} tok/s)")
    print(f"  sample continuation: {gen[0, :8].tolist()}")
    if not bool(torch.isfinite(res["logits"]).all()):
        raise AssertionError("non-finite logits")
    cache_len = res["cache"]["len"].cpu()
    if not bool((cache_len == P + args.gen - 1).all()):
        raise AssertionError(f"cache length {cache_len.tolist()}, expected "
                             f"{P + args.gen - 1}")
    return {"tokens": gen, "tput": tput, "prefill_s": t_prefill,
            "decode_s": t_decode, "decode_mallocs":
            res.get("decode_mallocs"), "model": model,
            "cache": res["cache"], "prompts": prompts}


if __name__ == "__main__":
    main()
