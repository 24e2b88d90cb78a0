"""esp32_opus_player_tpu_torch: the PyTorch/CUDA port of
esp32_opus_player_tpu.

The host layer (Ogg demux, native CELT/SILK symbol phase, tables) is
shared with the JAX package, which the port imports but never its JAX
modules. The device layer is torch: plain torch around hand-written
CUDA kernels (csrc/), each with a plain torch twin that CPU tensors take.
Ported so far: the uniform fullband 20 ms CELT pool
(models.stream_pool.StreamPool).
"""
