#!/usr/bin/env python
"""Example: continuous streaming decode with bounded latency and a mid-stream
checkpoint/restore (the decoder state is a dict of tensors and ints).

    python -m ka9q_viterbi_comparison_tpu_torch.examples.streaming_decode
"""

import argparse

import numpy as np
import torch

from ka9q_viterbi_comparison_tpu_torch import StreamingDecoder, VITERBI27, soft8_spec
from ka9q_viterbi_comparison_tpu_torch.models.decoder import resolve_device
from ka9q_viterbi_comparison_tpu_torch.ops.encoder import encode_frames
from ka9q_viterbi_comparison_tpu_torch.utils.bits import bits_to_bytes


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    code, numeric = VITERBI27, soft8_spec(2)
    n_bytes = 512
    data = np.random.default_rng(0).integers(0, 256, size=(1, n_bytes), dtype=np.uint8)
    syms = encode_frames(code, numeric, torch.from_numpy(data)).to(device)

    dec = StreamingDecoder(code, numeric, batch=1, traceback_depth=64, device=device)
    out_bits = []
    chunk = 100 * code.R
    for i in range(0, syms.shape[1], chunk):
        out_bits.append(dec.push(syms[:, i:i + chunk]))
        if i == chunk * 3:  # checkpoint and resume on a new decoder mid-stream
            state = dec.checkpoint()
            dec = StreamingDecoder(code, numeric, batch=1, traceback_depth=64, device=device)
            dec.restore(state)
    out_bits.append(dec.flush(endstate=0))

    bits = torch.cat(out_bits, dim=1)[:, :n_bytes * 8]
    ok = bool((bits_to_bytes(bits).cpu().numpy() == data).all())
    print(f"streamed {syms.shape[1]} symbols in {chunk}-symbol chunks on {device}; "
          f"decoded correctly: {ok}")


if __name__ == "__main__":
    main()
