"""esp32_opus_player_tpu_torch: the PyTorch/CUDA port of
esp32_opus_player_tpu.

It imports neither JAX nor the JAX package: it keeps its own copy of the
host layer (Ogg demux, the native CELT/SILK symbol phase, tables). The
device layer is torch: plain torch around hand-written CUDA kernels
(csrc/), each with a plain torch version that CPU tensors take. Entry
points: models.stream_pool.StreamPool (CELT at every frame size, mono
SILK with loss), entry.entry() (one batched CELT synthesis step) and the
bench, `python -m esp32_opus_player_tpu_torch.bench`.
"""
