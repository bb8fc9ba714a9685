"""The peak of the memory PyTorch's allocator held on the device during the window, in GiB."""


def read(run):
    return run.window_peak_bytes / 2**30 if run.window_peak_bytes else None
