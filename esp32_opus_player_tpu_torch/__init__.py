"""esp32_opus_player_tpu_torch: the PyTorch/CUDA port of
esp32_opus_player_tpu.

It imports neither JAX nor the JAX package: it keeps its own copy of the
host layer (Ogg demux, the range decoder, the native CELT/SILK symbol
phase, tables) and of the scalar decoders. The device layer is torch:
plain torch around hand-written CUDA kernels (csrc/), each with a plain
torch version that CPU tensors take. Entry points: decode_file,
decode_to_wav, OpusFile and OpusDecoder (the scalar route, every stream
kind; its one device call is a lost CELT frame's pitch conceal),
models.stream_pool.StreamPool (batched CELT at every frame size, mono
SILK with loss; chained, mode-switching and multistream sources through
the scalar route), entry.entry() (one batched CELT synthesis step) and
the bench, `python -m esp32_opus_player_tpu_torch.bench`. Each runs on
the card unless the caller passes device="cpu".
"""
from .api import (DecoderConfig, OpusFile, decode_file, decode_to_wav,
                  write_wav)
from .models.opus_decoder import OpusDecoder

__all__ = [
    "DecoderConfig", "OpusFile", "OpusDecoder", "decode_file",
    "decode_to_wav", "write_wav",
]
