"""The flight recorder's tests (``tests/test_flight.py``): span trees,
trace propagation over the gRPC wire, sampling, the roll-up and its
reconciliation with the simulator's tick phases, run against the port."""

from test_torch_twins import load_twin

globals().update(load_twin(
    "test_flight",
    rewrites=[
        ("from slurm_bridge_tpu_torch.wire import workload_pb2 as pb\n",
         "from slurm_bridge_tpu_torch.wire import pb\n"),
        # the port's phases are its spans' durations, so the reconciliation
        # holds per tick on one clock, where the reference compares the
        # median of its perf_counter stamps with the spans' median
        ("    def test_phase_tree_reconciles_with_tick_p50(self, runs):\n",
         "    def test_phase_tree_reconciles_with_tick_p50(self):\n"),
        ("        on, _ = runs\n"
         "        fr = on.flight_record\n"
         '        assert fr["ticks"] == on.shape["ticks"]\n'
         "        # abs floor: at toy tick sizes (~5 ms) scheduler-internal spans\n"
         "        # vs the harness's perf_counter stamps can differ by fractions\n"
         "        # of a millisecond of pure measurement noise on a loaded CI box;\n"
         "        # the ±5% contract binds at real scale (the 500k CLI gate)\n"
         '        assert fr["phase_sum_p50_ms"] == pytest.approx(\n'
         '            fr["tick_span_p50_ms"], rel=0.05, abs=2.0\n'
         "        )\n"
         "        # ... and the timing headline's phases are the span phases minus\n"
         "        # the harness's own verify bookkeeping\n"
         '        tick_p50 = on.timing["tick_p50_ms"]\n'
         '        verify = fr["phases_p50_ms"].get("verify", 0.0)\n'
         '        assert fr["phase_sum_p50_ms"] - verify == pytest.approx(\n'
         "            tick_p50, rel=0.10, abs=1.0\n"
         "        )\n"
         "        for phase in PHASES:\n"
         '            assert phase in fr["phases_p50_ms"]\n'
         "\n",
         "        # the port's phases are its spans' own durations (Tracer.tally), so\n"
         "        # tick by tick the span-derived phases add up to the tick the\n"
         "        # harness reports and stay inside the root span\n"
         "        h = SimHarness(_tiny())\n"
         "        result = h.run()\n"
         "        records = result.flight_ticks\n"
         '        assert len(records) == len(h._tick_phases) == result.shape["ticks"]\n'
         "        for rec, phases in zip(records, h._tick_phases):\n"
         "            lifted = h.flight.phases_ms(rec)\n"
         "            # one clock: equal up to the record's rounding to a microsecond\n"
         "            assert sum(lifted[p] for p in PHASES) == pytest.approx(\n"
         '                phases["tick"], abs=1e-2\n'
         "            )\n"
         '            assert sum(lifted.values()) <= rec["total_ms"] + 1e-2\n'
         "        fr = result.flight_record\n"
         '        assert fr["ticks"] == result.shape["ticks"]\n'
         '        assert fr["phase_sum_p50_ms"] == pytest.approx(\n'
         '            fr["tick_span_p50_ms"], rel=0.05, abs=2.0\n'
         "        )\n"
         "        for phase in PHASES:\n"
         '            assert phase in fr["phases_p50_ms"]\n'
         "\n"),
    ],
))
