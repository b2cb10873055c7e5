"""The program's expert choices at the served positions, recorded from
``kubetpu_torch.jobs.model._top_k`` inside the server's own prefill chunks
and decode steps. For calibration and the rehearsal only: the benchmark's
timed runs never record them (each recording waits for the device)."""

from __future__ import annotations


class Routes:
    """``sets[(rid, position, layer)]`` -> the frozenset of the experts the
    program chose there, for every decode row and the last prompt row of
    every final prefill chunk."""

    def __init__(self, server, model_lib) -> None:
        self.sets = {}
        self._ctx = []
        self._layer = 0
        self._model_lib = model_lib
        self._top_k = top_k = model_lib._top_k

        def recording(probs, k):
            vals, idx = top_k(probs, k)
            rows = idx.reshape(-1, k)
            for i, key in self._ctx:
                self.sets[key + (self._layer,)] = frozenset(
                    rows[i].tolist())
            self._layer += 1
            return vals, idx

        model_lib._top_k = recording
        chunk, step = server._prefill_chunk_device, server._device_step

        def prefill(prompt, slot, pos, take, final):
            rid = server._slot_rid[slot]
            self._ctx = [(take - 1, (rid, pos + take - 1))] if final else []
            self._layer = 0
            return chunk(prompt, slot, pos, take, final)

        def decode():
            self._ctx = [(b, (server._slot_rid[b], int(server.pos[b])))
                         for b in range(server.n_slots) if server.active[b]]
            self._layer = 0
            return step()

        server._prefill_chunk_device = prefill
        server._device_step = decode

    def close(self) -> None:
        self._model_lib._top_k = self._top_k
