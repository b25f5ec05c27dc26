"""Deterministic fault injection for the recovery paths.

Every scenario is driven by one seeded `numpy` Generator, so a given
(seed, scenario sequence) corrupts the same words / crashes the same
prefetch step on every run — and draws in the reference package's order,
so one seed corrupts the same block, word and bit in both packages. The
chaos harness and the tests assert exact recovery counters, not
"something recovered". The injector only touches state the resilience
layer claims to recover from: payload words (parity-repairable), the
digest table (detectable, never silently trusted), decode calls
(transient, retryable) and the prefetch producer (worker restart).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.format import block_payload_bounds


class TransientDecodeError(RuntimeError):
    """A decode call failed for a non-data reason (injected); retrying
    the same call is expected to succeed."""


class PrefetchCrash(RuntimeError):
    """The async prefetch producer died mid-stream (injected)."""


class FaultInjector:
    """Seeded, scenario-driven fault injection.

    Each scenario method both mutates the target and appends a record to
    `self.log` (scenario name + the exact coordinates hit), so tests can
    cross-check what recovery *should* have had to fix.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.rng = np.random.default_rng(self.seed)
        self.log: list = []

    def _record(self, scenario: str, **details):
        entry = {"scenario": scenario, **details}
        self.log.append(entry)
        return entry

    # -- data corruption ---------------------------------------------------

    def flip_payload_word(self, decoder, block: Optional[int] = None,
                          word: Optional[int] = None) -> dict:
        """Flip one random bit of one payload word of `block` (a random
        block with a nonempty payload if None), in BOTH the host archive
        and the decoder's device-resident words — the corruption must
        survive cache re-decodes, like real rot on the resident copy
        would. Draws block, then word, then bit."""
        a = decoder.archive
        starts, ends = block_payload_bounds(a)
        if block is None:
            nonempty = np.nonzero(ends > starts)[0]
            if nonempty.size == 0:
                raise ValueError("archive has no nonempty payloads to corrupt")
            block = int(self.rng.choice(nonempty))
        b = int(block)
        if word is None:
            word = int(self.rng.integers(int(starts[b]), int(ends[b])))
        w = int(word)
        bit = int(self.rng.integers(0, 16))
        a.words[w] ^= np.uint16(1 << bit)
        # set (never xor) the device word: on the CPU the resident buffer
        # may share memory with the host archive
        decoder.da.words[w] = int(a.words[w:w + 1].view(np.int16)[0])
        return self._record("flip_payload_word", block=b, word=w, bit=bit)

    def corrupt_digest(self, decoder, block: Optional[int] = None) -> dict:
        """Flip one random bit of one block's stored FNV digest. Not
        parity-repairable (parity covers payloads, not the table): the
        re-verify after reconstruction must still fail, so the block is
        reported unrecoverable — never silently accepted."""
        a = decoder.archive
        b = int(block if block is not None
                else self.rng.integers(0, a.n_blocks))
        bit = int(self.rng.integers(0, 64))
        a.block_fnv[b] ^= np.uint64(1 << bit)
        return self._record("corrupt_digest", block=b, bit=bit)

    # -- transient / process failures --------------------------------------

    def transient_failures(self, decoder, n: int = 1) -> dict:
        """Arm the decoder's fault hook to raise `TransientDecodeError`
        on the next `n` decode calls, then disarm itself."""
        remaining = [int(n)]

        def hook():
            if remaining[0] > 0:
                remaining[0] -= 1
                if remaining[0] == 0:
                    decoder.fault_hook = None
                raise TransientDecodeError(
                    f"injected transient decode failure "
                    f"({int(n) - remaining[0]}/{int(n)})")

        decoder.fault_hook = hook
        return self._record("transient_failures", n=int(n))

    def crashing_producer(self, produce, at_step: int):
        """Wrap a prefetch producer so it raises `PrefetchCrash` once,
        the first time it is asked for step `at_step`."""
        crashed = [False]
        self._record("crashing_producer", at_step=int(at_step))

        def wrapped(step):
            if step == int(at_step) and not crashed[0]:
                crashed[0] = True
                raise PrefetchCrash(
                    f"injected prefetch worker crash at step {step}")
            return produce(step)

        return wrapped

    # -- distributed failures ----------------------------------------------

    def drop_shard(self, sharded, shard: Optional[int] = None) -> dict:
        """Zero one shard's device-resident words: needs mesh-partitioned
        residency, which is not ported yet."""
        raise NotImplementedError(
            "FaultInjector.drop_shard is not ported yet: it comes with the "
            "multi-GPU residency slice of the PyTorch port")
