"""The window's peak of device memory allocated by the program
(`torch.cuda.max_memory_allocated`, reset before the window), in GiB: it
bounds how many sequences one card steps together."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
