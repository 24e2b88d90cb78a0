"""The benchmark's plain reference decoder: a frozen copy of the scalar
Opus route of esp32_opus_player_tpu_torch (host/packet.py,
host/range_decoder.py, ops/fixed_point.py, ops/celt/{bands,synthesis,
pvq,math}.py, ops/silk/{macros,decode,nlsf,core,plc,resampler,stereo}.py,
ops/tables/*.py, models/{opus,celt,silk}_decoder.py), numpy and Python
ints only, one packet at a time. It imports nothing of the decoder under
test, so a later change to that package cannot move the yardstick. The
CELT pitch conceal (float32 in the decoder under test) is left out.

The scalar route was held bit-exact to tests/golden (the reference C
decoder's PCM) when it was copied; bench_port/tests hold this copy there.
"""
