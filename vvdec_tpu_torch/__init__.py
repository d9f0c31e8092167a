"""vvdec_tpu_torch — the PyTorch/CUDA port of the vvdec_tpu VVC (H.266)
Main10 decoder, for one NVIDIA H100.

- **Host plane** (Python / C extension, scalar): Annex-B / NAL parsing,
  high-level syntax, CABAC, partitioning and the deblock strength
  derivation.  It is a vendored copy of vvdec_tpu's host plane (see
  `_vendored.py`), so the port runs without the JAX package.
- **Device plane** (PyTorch on CUDA): dequant + inverse transform (a
  hand-written Hopper kernel, `csrc/itx.cu`), the intra wavefront scan
  (planar, DC, angular, MIP, CCLM; intra LMCS), the in-loop filters
  (deblocking, SAO, ALF, CC-ALF) and the 10-bit output pack, all in
  device memory.  Every stage is held bit for bit to the JAX reference.
- **Public surface**: `api.Decoder` (the vvdec_decoder_open /
  vvdec_decode analog, with concealment, recon-while-parse threads and
  film grain), the `vvdecapp` CLI (`python -m vvdec_tpu_torch.app`) and
  the GOP worker pool (`parallel.decode_annexb_parallel`).

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"

import os as _os

# The host plane's numpy work is all small strided views; BLAS worker
# threads only spin and steal cores from the parse/recon overlap.  Pin
# BLAS to one thread unless the user chose otherwise, BEFORE numpy loads.
for _v in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    _os.environ.setdefault(_v, "1")

from vvdec_tpu_torch.api import Decoder, DecoderParams, Frame  # noqa: E402,F401
from vvdec_tpu_torch.decoder import StreamDecoder, decode_annexb  # noqa: E402,F401
