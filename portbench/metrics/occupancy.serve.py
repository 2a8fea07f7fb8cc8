"""Slots filled: the window's requests over its waves' slots
(``EngineStats`` ``spgemm_requests`` over ``spgemm_waves`` x max_batch),
in %."""


def read(rec):
    eng = rec.get("engine", {})
    waves = eng.get("spgemm_waves", 0)
    if not waves:
        return None
    return 100.0 * eng["spgemm_requests"] / (waves * rec["max_batch"])
