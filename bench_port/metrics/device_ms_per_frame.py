"""device_ms_per_frame (ms/frame): the device time of the frame steps of
the windows dispatched inside the measured window, over their frames:
StreamPool.window_device_ms(), the CUDA events the pool records around
each window's frame steps (it keeps the latest 1024 windows)."""


def read(run):
    frames = sum(k for k, _ in run.window_device_ms)
    if not frames:
        return None
    return sum(ms for _, ms in run.window_device_ms) / frames
