"""Host milliseconds a round spends in the engine outside its host sync:
the program's ``exec/chunk`` spans less their ``exec/host_sync`` spans,
over the traced rounds.  Sampling batches and issuing the round's work."""


def read(tr):
    chunk = sum(b - a for n, a, b in tr.spans if n == "exec/chunk")
    sync = sum(b - a for n, a, b in tr.spans if n == "exec/host_sync")
    if chunk == 0.0 or not tr.rounds:
        return None
    return 1e3 * (chunk - sync) / tr.rounds
