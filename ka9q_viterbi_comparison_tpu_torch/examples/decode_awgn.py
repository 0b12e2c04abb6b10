#!/usr/bin/env python
"""Example: batched soft-decision decode over an AWGN channel.

Encodes a batch of random frames with the K=7 rate-1/2 code, passes them
through a 3 dB Eb/N0 channel, decodes them on the card (``--device cpu`` for
the CPU) and prints the coded BER beside the uncoded one.

    python -m ka9q_viterbi_comparison_tpu_torch.examples.decode_awgn
"""

import argparse

import numpy as np
import torch

from ka9q_viterbi_comparison_tpu_torch import VITERBI27, decode_symbols, soft16_spec
from ka9q_viterbi_comparison_tpu_torch.harness.ber import BerPoint
from ka9q_viterbi_comparison_tpu_torch.models.decoder import resolve_device
from ka9q_viterbi_comparison_tpu_torch.ops.channel import awgn_symbols
from ka9q_viterbi_comparison_tpu_torch.utils.bits import count_bit_errors


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    code, numeric = VITERBI27, soft16_spec(2)
    batch, frame_bytes, ebn0_db = 64, 256, 3.0

    data = np.random.default_rng(0).integers(0, 256, size=(batch, frame_bytes), dtype=np.uint8)
    gen = torch.Generator(device=device).manual_seed(0)
    symbols = awgn_symbols(code, numeric, data, ebn0_db, gen, device)
    decoded = decode_symbols(code, numeric, symbols, frame_bytes * 8, device=device)

    point = BerPoint(ebn0_db, data.size * 8, count_bit_errors(decoded, data), batch,
                     int((decoded.cpu().numpy() != data).any(axis=1).sum()))
    print(f"{code.name} @ {ebn0_db} dB Eb/N0 on {device}: {point.bits} bits, "
          f"coded BER = {point.ber:.2e} (uncoded {point.uncoded_ber:.2e})")


if __name__ == "__main__":
    main()
