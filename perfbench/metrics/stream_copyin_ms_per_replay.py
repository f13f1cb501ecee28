"""stream_copyin_ms_per_replay: host ms in the program's span
engine.copy_in (the state's copies into the graph's static buffers) per
replay of a traced stream run."""

from perfbench.program_trace import stream_ms_per


def read(ctx):
    return stream_ms_per(ctx, ("engine.copy_in",), "stream.replays")
