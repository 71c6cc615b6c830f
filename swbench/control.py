"""The controls: the plain reference put in the program's place, with one
guarantee of the configuration broken, so that ``correct`` has to come out
false (``run.py --control 1``; never in a driver's runs).

- EC cells: every GF(2^8) product the codec computes is replaced by the
  reference's arithmetic with each coefficient taken as 1 (XOR parity, the
  code a cheaper implementation is tempted by, which survives one lost
  shard where the configuration's RS(10,4) survives four).
- The query cell: each ``/_query`` is answered by the reference's Q6 filter
  reading the fields as float32 against the literals (the narrower type a
  scan on the card is tempted by), where the configuration compares as
  float64.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import q6, rs


def xor_codec(codec) -> None:
    """Make ``codec`` (the port's ``Codec``) compute XOR parity on the host."""

    def matmul_device(matrix, data_dev, out=None, accumulate=False):
        if data_dev.is_cuda:
            torch.cuda.synchronize(data_dev.device)
        got = torch.from_numpy(rs.matmul_xor(np.asarray(matrix), data_dev.cpu().numpy()))
        got = got.to(data_dev.device)
        if out is None:
            out = got
        elif accumulate:
            out ^= got
        else:
            out.copy_(got)
        if data_dev.is_cuda:
            torch.cuda.synchronize(data_dev.device)
        return out

    codec.matmul_device = matmul_device


def float32_q6(volume_server_module, params: dict) -> None:
    """Answer every ``/_query`` of the port's volume servers with the
    reference's Q6 rows read in float32."""

    def execute_request(data, req, backend=None):
        rows = q6.rows(data, params, q6.narrow)
        return 200, {"rows": [dict(zip(q6.PROJECT, r)) for r in rows], "count": len(rows)}

    volume_server_module.execute_request = execute_request
