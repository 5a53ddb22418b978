"""decode_files_per_s: the files a FileCache's producers decoded over the
seconds they spent in their decode calls, over the whole run (set-up, window
and traced epoch): the decoder's rate while busy, counted on the producer
threads (``COUNTERS``' ``decode.files`` and ``decode.seconds``), where spans
are not recorded."""


def read(stretch):
    try:
        from gan_tpu_torch.utils.profiling import COUNTERS
    except ImportError:   # a program that counts nothing
        return None
    sums = COUNTERS.snapshot()
    if not sums.get("decode.files") or not sums.get("decode.seconds"):
        return None
    return sums["decode.files"] / sums["decode.seconds"]
