"""Batched serving driver of the LLM scaffold: the continuous-batching
decode loop over a request queue, the counterpart of
``repro.launch.serve``.

* a fixed decode batch of ``--batch`` slots, each slot holding one
  request's KV cache row;
* a new request is prefilled alone (batch 1) into a fresh cache row,
  which is spliced into a free slot (a Mamba layer's ``conv`` and ``h``
  as an attention layer's k and v);
* an encoder-decoder request carries its audio frames (frontend_len,
  D), which its prefill encodes into the cross-attention caches; slot
  and row caches hold ``enc_len = frontend_len`` keys, as the
  reference's ``build_cell`` builds them (its serving loop passes no
  frames and builds caches of ``enc_len`` 0, so it cannot serve one);
* one decode tick advances every slot by one token (``make_serve_step``,
  without a mesh: the reference's serving loop runs at ``model`` = 1);
* a finished slot (``max_new`` tokens, the first from the prefill) is
  refilled from the queue at the next tick; ``max_new == 1`` finishes at
  the prefill, and every request of the queue is served.

Weights are random, from ``--seed``, as the reference's are.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --preset smoke \
      --requests 8 --batch 4 --max-new 16
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.launch.steps import make_serve_step
from repro_torch.launch.train import preset_config
from repro_torch.models import model as M
from repro_torch.models.model import forward


def enc_len(cfg) -> int:
    """Encoder positions the cross-attention caches hold."""
    return cfg.frontend_len if cfg.kind == "encdec" else 0


class SlotCache:
    """The decode batch's caches (one dict per layer, batch on axis 0)
    with a per-slot splice."""

    def __init__(self, cfg, batch, s_max, dtype, device=None):
        self.caches = M.init_cache(cfg, batch, s_max, dtype=dtype, device=device,
                                   enc_len=enc_len(cfg))

    def splice(self, row_caches, slot: int):
        """Copy a batch-1 cache row into slot ``slot``."""
        for full, row in zip(self.caches, row_caches):
            for name, t in full.items():
                t[slot:slot + 1].copy_(row[name])


def serve(cfg, model, queue, *, batch, max_new, s_max, device=None, frames=None):
    """Serve ``queue`` (int32 prompts) through ``model`` greedily with
    ``batch`` slots; an encoder-decoder's requests carry ``frames``, one
    (frontend_len, D) array each.  Returns (the generated tokens of each
    request, the decode ticks run)."""
    dev = resolve_device(device)
    if cfg.kind == "encdec" and (frames is None or len(frames) != len(queue)):
        raise ValueError(f"{cfg.name}: every request needs its audio frames")
    params = model.params()
    dtype = getattr(torch, cfg.compute_dtype)
    serve_step = make_serve_step(cfg)
    slots = SlotCache(cfg, batch, s_max, dtype, dev)
    cur_tok = np.zeros((batch, 1), np.int32)
    cur_pos = np.zeros((batch,), np.int32)
    remaining = np.zeros((batch,), np.int32)  # tokens left; 0 = free
    outputs: list[list[int]] = [[] for _ in range(len(queue))]
    slot_req = [-1] * batch
    next_req = done = ticks = 0

    while done < len(queue):
        # Fill free slots by prefilling queued requests (batch-1 prefill).
        for s in range(batch):
            if remaining[s] == 0 and next_req < len(queue):
                prompt = torch.as_tensor(queue[next_req][None, :], device=dev)
                row = M.init_cache(cfg, 1, s_max, dtype=dtype, device=dev, enc_len=enc_len(cfg))
                kw = {}
                if frames is not None:
                    kw["enc_frames"] = torch.as_tensor(frames[next_req][None], device=dev)
                logits, row = forward(params, cfg, prompt, caches=row, mode="prefill", **kw)
                slots.splice(row, s)
                cur_tok[s, 0] = int(torch.argmax(logits[0, -1]))
                cur_pos[s] = prompt.shape[1]
                # prefill already produced one of the max_new tokens
                remaining[s] = max_new - 1
                slot_req[s] = next_req
                outputs[next_req].append(int(cur_tok[s, 0]))
                next_req += 1
                if remaining[s] == 0:  # max_new == 1: done at prefill
                    done += 1

        if remaining.max() == 0:
            # Every slot is free: go back and prefill the rest of the queue
            # (the reference breaks here, which leaves the requests after
            # the first ``batch`` unserved when max_new == 1).
            continue
        # One decode tick for the whole batch.
        nxt, slots.caches = serve_step(params, slots.caches,
                                       torch.as_tensor(cur_tok, device=dev),
                                       torch.as_tensor(cur_pos, device=dev))
        nxt = nxt[:, 0].cpu().numpy()
        ticks += 1
        for s in range(batch):
            if remaining[s] > 0:
                outputs[slot_req[s]].append(int(nxt[s]))
                cur_tok[s, 0] = nxt[s]
                cur_pos[s] += 1
                remaining[s] -= 1
                if remaining[s] == 0:
                    done += 1
    return outputs, ticks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, _, _ = preset_config(args.preset)
    model = M.Model(cfg, device=dev, seed=args.seed)

    # Request queue: deterministic synthetic prompts.
    rng = np.random.default_rng(args.seed)
    queue = [rng.integers(1, cfg.vocab_size, size=args.prompt_len)
             .astype(np.int32) for _ in range(args.requests)]
    frames = None
    if cfg.kind == "encdec":
        frames = [rng.standard_normal((cfg.frontend_len, cfg.d_model)).astype(np.float32)
                  for _ in range(args.requests)]

    t0 = time.time()
    outputs, ticks = serve(cfg, model, queue, batch=args.batch, max_new=args.max_new,
                           s_max=args.s_max, device=dev, frames=frames)
    wall = time.time() - t0
    total_new = sum(len(o) for o in outputs)
    print(f"[serve] {args.requests} requests, {total_new} tokens, "
          f"{ticks} decode ticks, {wall:.2f}s "
          f"({total_new/max(wall,1e-9):.1f} tok/s) on {dev}")
    for i, o in enumerate(outputs):
        print(f"  req{i}: {o[:8]}{'...' if len(o) > 8 else ''}")
    return outputs


if __name__ == "__main__":
    main()
