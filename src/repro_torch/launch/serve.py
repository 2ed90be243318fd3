"""Serving launcher of the port: batched prefill and greedy decode of the
LM.

    python -m repro_torch.launch.serve --arch granite-8b [--reduced] \\
        [--batch 8] [--prompt-len 32] [--gen-len 32] [--device cuda]
    python -m repro_torch.launch.serve --arch granite-8b --engine \\
        [--requests 8] [--ckpt PATH [--ckpt-select params]] ...

Counterpart of ``repro.launch.serve`` for all ten architectures:
granite-8b, gemma2-27b, gemma3-12b, starcoder2-3b, phi3.5-moe-42b-a6.6b,
kimi-k2-1t-a32b, mamba2-780m, zamba2-2.7b, llama-3.2-vision-11b and
seamless-m4t-medium.  The default is the fixed-batch loop: one prefill
of ``--batch`` random prompts of ``--prompt-len`` tokens into a cache of
``prompt-len + gen-len`` positions (a ring of the window in a
sliding-window layer; a Mamba2 mixer keeps its state and conv window,
and needs a prompt of at least 3 tokens), then ``gen-len - 1`` greedy
decode steps, every sequence at the same position, so each global
layer's attention, each cross layer's self-attention and each of
zamba2's shared-attention layers is one ``flash_decode`` launch a step
in a model without an attention softcap (the rest run the reference's
masked attention).  The VLM (llama-3.2-vision-11b) draws
``(batch, num_image_tokens, d_model)`` image embeddings as its memory,
the audio model (seamless-m4t-medium) ``(batch, encoder_frames,
d_model)`` frame embeddings that ``encode_audio`` turns into its memory
(before the prefill's clock starts, as in the reference); the prefill
keeps the memory in the cache, and each cross layer's cross-attention
over it is one more ``flash_decode`` launch a step.  It prints the
reference's two lines: prefill ms, and decode ms with tok/s.

``--engine`` runs the continuous-batching :class:`~repro_torch.serving.
ServingEngine` instead: ``--requests`` requests with random prompts of 4
to ``--prompt-len`` tokens are admitted into ``--batch`` decode slots
from a parameter source (fresh weights by default; ``--ckpt`` an npz file
or a checkpoint directory, newest step wins, ``--ckpt-select`` its
subtree of params).  Slots sit at different positions, so its decode runs
the reference's masked attention.  As the reference's, the engine passes
no memory: a cross layer's cross-attention then runs as a second causal
self-attention (``models.transformer``).

Weights, prompts and memories are drawn from seeded ``torch.Generator``s on the
device, so their values differ from the JAX launcher's while the shapes
and the computation match.  There is no mesh: the model runs on one
device.  ``--device`` is ``cuda`` (the default; raises without a card) or
``cpu``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def make_decode_step(cfg: ModelConfig) -> Callable:
    """``decode(params, token (B, 1), cache) -> (next_token (B, 1) int32,
    logits (B, 1, V), cache)``: one greedy step (the reference's
    ``launch/steps.py:167``)."""
    def decode_step(params, token, cache):
        logits, cache = T.decode_step(params, cfg, token, cache)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, logits, cache

    return decode_step


def make_memory(params: dict, cfg: ModelConfig, batch: int,
                device: torch.device) -> torch.Tensor | None:
    """The cross layers' memory of the reference's launcher, or None for a
    config without one: a VLM's ``(batch, num_image_tokens, d_model)``
    stub image embeddings, or an audio model's ``(batch, encoder_frames,
    d_model)`` stub frame embeddings run through ``encode_audio``; each a
    float32 Normal(0, 1) draw of a generator on ``device`` seeded with 2,
    cast to the model dtype."""
    if cfg.family not in ("vlm", "audio"):
        return None
    rows = cfg.num_image_tokens if cfg.family == "vlm" else \
        cfg.encoder_frames
    x = torch.randn((batch, rows, cfg.d_model), device=device,
                    generator=torch.Generator(device).manual_seed(2)
                    ).to(L.dtype_of(cfg))
    return x if cfg.family == "vlm" else T.encode_audio(params, cfg, x)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fixed_batch(params: dict, cfg: ModelConfig, prompts: torch.Tensor,
                    gen_len: int, *, memory: torch.Tensor | None = None,
                    log: Callable[[str], None] = print) -> dict:
    """Prefill ``prompts`` (B, S), with the cross layers' ``memory`` (B, T,
    D) when the model has one, into a cache of S + ``gen_len`` positions
    and decode ``gen_len - 1`` greedy steps.  Returns the seconds of the
    prefill and of the decode loop (each ending in a device
    synchronisation) and the tokens (B, gen_len), the first from the
    prefill's logits."""
    dev = prompts.device
    batch, prompt_len = prompts.shape
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = T.prefill(params, cfg, prompts, memory,
                              cache_len=prompt_len + gen_len)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    log(f"prefill {batch}x{prompt_len}: {prefill_s * 1e3:.0f} ms")
    decode = make_decode_step(cfg)
    token = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
    tokens = [token]
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        token, _, cache = decode(params, token, cache)
        tokens.append(token)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    steps = gen_len - 1
    rate = batch * steps / decode_s if decode_s else 0.0
    log(f"decode {steps} steps: {decode_s * 1e3:.0f} ms ({rate:,.0f} tok/s)")
    return {"prefill_s": prefill_s, "decode_s": decode_s,
            "decode_steps": steps, "tokens": torch.cat(tokens, dim=1)}


def run_engine(args: argparse.Namespace, cfg: ModelConfig,
               device: torch.device, *, log: Callable[[str], None] = print
               ) -> dict:
    """Continuous-batching serving from a ParamSource; returns the engine's
    ``run()`` stats."""
    from repro_torch.serving import (Request, ServingConfig, ServingEngine,
                                     StaticSource)
    if args.ckpt:
        source = StaticSource.from_checkpoint(
            args.ckpt, select=args.ckpt_select or None, device=device)
    else:
        source = StaticSource(T.init_model(
            cfg, generator=torch.Generator(device).manual_seed(0),
            device=device))
    scfg = ServingConfig(num_slots=args.batch,
                         max_len=args.prompt_len + args.gen_len)
    eng = ServingEngine(source, cfg, config=scfg)
    rng = np.random.default_rng(0)
    for uid in range(args.requests):
        plen = int(rng.integers(4, args.prompt_len + 1))
        eng.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, plen,
                                dtype=np.int64).astype(np.int32),
            max_new_tokens=args.gen_len))
    stats = eng.run()
    log(f"engine: {stats['completed']} completed in "
        f"{stats['decode_steps']} steps, "
        f"{stats['tokens_per_s']:,.0f} tok/s, slot util "
        f"{stats['slot_utilization']:.2f}, param v{stats['param_version']} "
        f"(step {stats['param_step']}), clamped "
        f"{stats['clamped_requests']}")
    return stats


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching ServingEngine from a "
                         "ParamSource instead of the fixed-batch loop")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests to submit with --engine")
    ap.add_argument("--ckpt", default="",
                    help="serve params from this checkpoint (npz file or "
                         "checkpoint dir) instead of fresh init")
    ap.add_argument("--ckpt-select", default="",
                    help="subtree of the checkpoint holding the params "
                         "(e.g. 'params' for a full train state)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        T.check_supported(cfg)
    except NotImplementedError as e:
        ap.error(str(e))
    if args.gen_len < 1 or args.prompt_len < 1:
        ap.error("--prompt-len and --gen-len must be at least 1")
    dev = resolve_device(args.device)
    if args.engine:
        return run_engine(args, cfg, dev)
    params = T.init_model(cfg, generator=torch.Generator(dev).manual_seed(0),
                          device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=torch.Generator(dev).manual_seed(1),
                            device=dev)
    memory = make_memory(params, cfg, args.batch, dev)
    return run_fixed_batch(params, cfg, prompts, args.gen_len, memory=memory)


if __name__ == "__main__":
    main()
