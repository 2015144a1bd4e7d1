"""Host ms an MCS of the study's key chain (the built engine's
``schedule_batch``) over one chunk of the trials' keys as the study's
first chunk passed them, timed by the host clock after the window over
calls that span at least 0.3 s: the key chain that the card's launches
wait for."""
import time

SPAN_S = 0.3


def read(ctx):
    k = ctx.keychain
    if k.keys is None:
        return None
    n = ctx.cell.chunk
    k.schedule_batch(k.keys, n)
    calls, t0 = 0, time.perf_counter()
    while True:
        k.schedule_batch(k.keys, n)
        calls += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= SPAN_S:
            return elapsed / calls / n * 1e3
