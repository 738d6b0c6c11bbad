"""Driver of the probe configurations: the exporter's probe batch, back to
back.

One item is what one refresh of ``TorchProbeSource`` costs: the probe batch
(``_refresh_heavy``, the body of the exporter's refresh thread, which swaps
in the batch's cache), then ``fetch()`` and the exporter's text encoder, so
that the batch's numbers reach a served page.  A batch that serves no fresh
numbers counts as failed.

What decides ``correct``, beside the limits in the configuration's file:

- every answer of the window: each read loop's sum and each matmul chain's
  sum, recorded as the program returned it, against the reference worked
  out from the probe's own stated inputs (the read buffer is ones; the
  chain's operands are drawn from generator seed 0);
- every series for every GPU on every page;
- every rate that a batch of the window served, as a share of its
  datasheet peak (989 TFLOP/s bf16, 3.35 TB/s): a rate above the peak is a
  wrong number on the dashboard, and one not above 0 reads as infinite;
- after the window, the same two layers at the timed sizes on inputs made
  from ``--seed``: the read kernel's every column and its loop's sum, and
  the long chain's sums over ``chain_check_pairs`` operand pairs (their
  root mean square: one sum's gap swings with the direction the chain's
  rounding takes, a mean over several does not).
"""

from __future__ import annotations

import math
import re

from gpubench import inputs, peaks
from gpubench.reference import probe as ref

#: the series a probe page serves for each GPU
SERIES = ("tpu_tensorcore_utilization", "tpu_hbm_used_bytes", "tpu_hbm_total_bytes",
          "tpu_hbm_bandwidth_gbps")
_LINE = re.compile(r'^(\w+)\{chip_id="(\d+)"[^}]*\} (\S+)$')
#: the probe source's own sizes that the configuration file states
SOURCE_KEYS = ("probe_matmul_size", "probe_matmul_iters", "probe_hbm_mb", "probe_hbm_k1",
               "probe_hbm_k2", "probe_ici_mb", "probe_heavy_interval")


class _Recorder:
    """Wraps the probe module's read loop and matmul chain so that each
    answer the window computes is kept as the program returned it (a 0-d
    tensor the program reads back itself): no work is added."""

    def __init__(self, probes):
        self.probes = probes
        self.read_loop, self.chain = probes._hbm_read_loop, probes._matmul_chain_sum
        self.reads: list = []
        self.chains: list = []

        def read_loop(x, block_rows, repeats):
            out = self.read_loop(x, block_rows, repeats)
            self.reads.append((tuple(x.shape), repeats, out))
            return out

        def chain(x, w, iters):
            out = self.chain(x, w, iters)
            self.chains.append((x.device, x.shape[0], iters, out))
            return out

        probes._hbm_read_loop, probes._matmul_chain_sum = read_loop, chain

    def clear(self) -> None:
        self.reads.clear()
        self.chains.clear()

    def restore(self) -> None:
        self.probes._hbm_read_loop, self.probes._matmul_chain_sum = self.read_loop, self.chain


class Driver:
    def __init__(self, cell, seed: int, devices: list):
        self.cell, self.seed, self.devices = cell, seed, devices
        self.c = cell.config
        self.pages: list = []
        self.caches: list = []

    def setup(self) -> None:
        from tpudash_torch.config import Config
        from tpudash_torch.exporter.textfmt import encode_samples_py
        from tpudash_torch.ops import kernels, probes
        from tpudash_torch.sources.probe import TorchProbeSource

        self.kernels, self.probes, self.encode = kernels, probes, encode_samples_py
        self.rec = _Recorder(probes)
        self.source = TorchProbeSource(
            Config(source="probe", extra={k: self.c[k] for k in SOURCE_KEYS}),
            devices=self.devices)
        if self.devices[0].type == "cuda":
            kernels.build_kernels()
        for _ in range(self.cell.traffic["warmup_items"]):
            self.item()

    def start_window(self) -> None:
        self.rec.clear()
        self.pages.clear()
        self.caches.clear()
        self.launches0 = self.kernels.launch_counts()["hbm_read"]

    def item(self) -> tuple:
        """One refresh and one served page: (work units, whether it served
        fresh numbers)."""
        before = self.source._cache
        self.source._refresh_heavy()
        cache = self.source._cache
        self.caches.append(dict(cache))
        self.pages.append(self.encode(self.source.fetch()))
        return 1, cache is not before

    def _rate_share(self, cache: dict) -> float:
        """The largest of a batch's rates as a share of its datasheet peak;
        inf where one is not above 0."""
        shares = []
        for i in range(len(self.devices)):
            shares += [cache[f"tflops_{i}"] / peaks.BF16_TFLOPS,
                       cache[f"hbm_gbps_{i}"] * 1e9 / peaks.HBM_BYTES_PER_S]
        return max(shares) if all(x > 0 for x in shares) else math.inf

    def window_counts(self) -> dict:
        """The work the window issued, as the harness counted it."""
        rows, cols = self.rec.reads[0][0] if self.rec.reads else (0, 0)
        return {
            "items": len(self.pages),
            "read_passes": sum(r for _, r, _ in self.rec.reads),
            "read_pass_bytes": peaks.read_pass_bytes(rows, cols),
            "read_launches": self.kernels.launch_counts()["hbm_read"] - self.launches0,
            "gemms": sum(i for _, _, i, _ in self.rec.chains),
            "gemm_flops": peaks.gemm_flops(*(3 * [self.rec.chains[0][1]])) if self.rec.chains else 0,
        }

    def free(self) -> None:
        self.rec.restore()
        self.source = None

    # -- correct ----------------------------------------------------------------
    def _served(self) -> dict:
        """Series missing from the window's pages: every series for every GPU
        on every page."""
        n = len(self.devices)
        missing = 0
        for page in self.pages:
            have = set()
            for line in page.splitlines():
                m = _LINE.match(line)
                if m and math.isfinite(float(m.group(3))):
                    have.add((m.group(1), int(m.group(2))))
            missing += sum((s, i) not in have for s in SERIES for i in range(n))
        return {"series_missing": missing if self.pages else math.inf}

    def _window_answers(self) -> dict:
        """Each recorded answer against the reference: a read loop over ones
        sums ``repeats × rows`` in each of its first 8 columns, exactly; a
        chain's sum is compared in units of its reference's size."""
        read_err = 0.0
        for (rows, _), repeats, out in self.rec.reads:
            read_err = max(read_err, abs(out.item() - 8.0 * repeats * rows))
        chain_gap, refs = 0.0, {}
        for dev, size, iters, out in self.rec.chains:
            key = (str(dev), size, iters)
            if key not in refs:
                ((x, w),) = inputs.chain_operands(size, 0, dev)
                refs[key] = ref.chain(x, w, iters)
            s, rss = refs[key]
            chain_gap = max(chain_gap, abs(out.item() - s) / rss)
        if not self.rec.reads or not self.rec.chains:
            read_err = chain_gap = math.inf
        return {"read_window_error": read_err, "chain_window_gap": chain_gap}

    def seeded(self, control: "str | None" = None) -> dict:
        """The read kernel and the chain at the timed sizes on inputs from
        the seed, against the reference; ``control`` puts the reference in
        the next precision below in the program's place."""
        c, dev = self.c, self.devices[0]
        rows = c["probe_hbm_mb"] * 2**20 // (4 * c["hbm_cols"])
        x = inputs.read_buffer(rows, c["hbm_cols"], self.seed, dev)
        passes = c["probe_hbm_k2"]
        want = ref.read_columns(x, passes)
        if control:
            got = ref.read_columns(x, passes, "bf16")
        else:
            kept = []
            orig = self.probes.hbm_read_pass

            def keep_last(*args, **kw):
                out = orig(*args, **kw)
                kept[:] = [out]
                return out

            self.probes.hbm_read_pass = keep_last
            try:
                total = self.rec.read_loop(x, c["hbm_block_rows"], passes).item()
            finally:
                self.probes.hbm_read_pass = orig
            got = kept[0][0].double()
        scale = x.double().abs().sum(0) * passes
        read_gap = ((got - want).abs() / scale).max().item()
        if not control:  # the loop's own answer, the sum of its first 8 columns
            read_gap = max(read_gap, abs(total - want[:8].sum().item()) / scale[:8].sum().item())
        size, iters = c["probe_matmul_size"], 3 * c["probe_matmul_iters"]
        gaps = []
        for a, w in inputs.chain_operands(size, self.seed + 3, dev, c["chain_check_pairs"]):
            s, rss = ref.chain(a, w, iters)
            got = ref.chain(a, w, iters, "fp8")[0] if control else self.rec.chain(a, w, iters).item()
            gaps.append((got - s) / rss)
        chain_gap = math.sqrt(sum(g * g for g in gaps) / len(gaps))
        return {"read_seeded_gap": read_gap, "chain_seeded_gap": chain_gap}

    def window_control(self) -> dict:
        """``chain_window_gap`` with the control in the program's place: the
        fp8 chain on the probe's own operands, at each length it runs."""
        c, dev = self.c, self.devices[0]
        ((x, w),) = inputs.chain_operands(c["probe_matmul_size"], 0, dev)
        gaps = []
        for iters in (c["probe_matmul_iters"], 3 * c["probe_matmul_iters"]):
            s, rss = ref.chain(x, w, iters)
            gaps.append(abs(ref.chain(x, w, iters, "fp8")[0] - s) / rss)
        return {"chain_window_gap": max(gaps)}

    def check(self) -> dict:
        rates = {"rate_share_max": max(map(self._rate_share, self.caches), default=math.inf)}
        return {**self._window_answers(), **self._served(), **rates, **self.seeded()}
