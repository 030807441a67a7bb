"""host_syncs.prefill: the host's waits for the device a traced batch
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize` calls) that start inside the program's spans."""

from shark_bench.metrics._spans import SYNC, count


def read(rec):
    return count(rec, "prefill", SYNC)
