"""The port's host layer against the JAX package's, case by case.

The port carries its own copy of every host module it runs (FASTA
reading, the suffix index, the mappers, the pileup, the host counters,
estimators and PHYLIP output, the CLI's parser, the reference pick,
complete deletion, ``-p`` positions and mapping checkpoints). Each case
feeds the same seeded numpy inputs to the port's copy and to the JAX
original and requires exact equality: integers, bytes and homology
tuples bit for bit.
"""

import contextlib
import io
import os
import time

import numpy as np
import pytest

import phylonium_tpu.cli as j_cli
import phylonium_tpu.config as j_config
import phylonium_tpu.core.anchor_stats as j_stats
import phylonium_tpu.core.anchors as j_anchors
import phylonium_tpu.core.complete_deletion as j_cd
import phylonium_tpu.core.filter as j_filter
import phylonium_tpu.core.homology as j_hom
import phylonium_tpu.core.lowmem as j_lowmem
import phylonium_tpu.core.map_native as j_map
import phylonium_tpu.core.pileup as j_pileup
import phylonium_tpu.core.reference_pick as j_pick
import phylonium_tpu.core.segsites as j_seg
import phylonium_tpu.data.sequence as j_seq
import phylonium_tpu.index.esa as j_esa
import phylonium_tpu.io.fasta as j_fasta
import phylonium_tpu.io.phylip as j_phylip
import phylonium_tpu.model.evo as j_evo
import phylonium_tpu.native as j_native
import phylonium_tpu.ops.bitplane_host as j_bitplane
import phylonium_tpu.ops.match_table as j_table
import phylonium_tpu.ops.pileup_prep as j_prep
import phylonium_tpu.ops.shapes as j_shapes
import phylonium_tpu.utils.checkpoint as j_ckpt
import phylonium_tpu.utils.progress as j_progress
import phylonium_tpu_torch.cli as t_cli
import phylonium_tpu_torch.config as t_config
import phylonium_tpu_torch.core.anchor_stats as t_stats
import phylonium_tpu_torch.core.anchors as t_anchors
import phylonium_tpu_torch.core.complete_deletion as t_cd
import phylonium_tpu_torch.core.filter as t_filter
import phylonium_tpu_torch.core.homology as t_hom
import phylonium_tpu_torch.core.lowmem as t_lowmem
import phylonium_tpu_torch.core.map_native as t_map
import phylonium_tpu_torch.core.pileup as t_pileup
import phylonium_tpu_torch.core.reference_pick as t_pick
import phylonium_tpu_torch.core.segsites as t_seg
import phylonium_tpu_torch.data.sequence as t_seq
import phylonium_tpu_torch.index.esa as t_esa
import phylonium_tpu_torch.io.fasta as t_fasta
import phylonium_tpu_torch.io.phylip as t_phylip
import phylonium_tpu_torch.model.evo as t_evo
import phylonium_tpu_torch.native as t_native
import phylonium_tpu_torch.ops.bitplane_host as t_bitplane
import phylonium_tpu_torch.ops.match_table as t_table
import phylonium_tpu_torch.ops.pileup_prep as t_prep
import phylonium_tpu_torch.ops.shapes as t_shapes
import phylonium_tpu_torch.utils.checkpoint as t_ckpt
import phylonium_tpu_torch.utils.progress as t_progress
from golden_panel import write_panel

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _genomes(seed: int = 3, n: int = 6, length: int = 5000) -> list[bytes]:
    """A base genome, mutants at 1..5 %, and a draft: two contigs joined
    by '!', the second reverse-complemented (reverse homologies)."""
    rng = np.random.default_rng(seed)
    base = ACGT[rng.integers(0, 4, length)]
    out = [base.tobytes()]
    for k in range(1, n - 1):
        arr = base.copy()
        hit = rng.random(length) < 0.01 * k
        arr[hit] = ACGT[(np.searchsorted(ACGT, arr[hit]) + rng.integers(1, 4, hit.sum())) % 4]
        out.append(arr.tobytes())
    half = length // 2
    out.append(out[1][:half] + b"!" + out[2][half:][::-1].translate(COMP))
    return out


@pytest.fixture(scope="module", autouse=True)
def _native_libraries():
    """Both packages' native libraries, loaded before the cases. The JAX
    package's build writes its library in place, so a test worker that
    loads it while another worker is still writing it finds a truncated
    file: wait for that build to finish, and fail with the last error if
    it never loads."""
    for _ in range(120):
        try:
            j_native.get_lib()
            break
        except OSError as exc:
            error = exc
            time.sleep(1)
    else:
        raise error
    t_native.get_lib()


def _tuples(hv) -> list[tuple]:
    return [(h.direction, h.index_reference, h.index_reference_projected,
             h.index_query, h.length) for h in hv]


def _mapped(pkg_seq, pkg_esa, pkg_stats, pkg_map, pkg_progress, genomes):
    """Index the first genome with the native backend and map them all."""
    subject = pkg_seq.Sequence("G0", genomes[0])
    ref = pkg_esa.ESAIndex(subject, backend="native")
    threshold = pkg_stats.min_anchor_length(
        0.025, pkg_seq.gc_content(subject.nucl), ref.size
    )
    bar = pkg_progress.ProgressBar("", len(genomes), enabled=False)
    queries = [np.frombuffer(g, np.uint8) for g in genomes]
    homologies = pkg_map.map_batch_native(ref._native, queries, threshold, bar, 0)
    raw = pkg_map.map_batch_native(ref._native, queries, threshold, bar, 0, raw=True)
    return ref, threshold, queries, homologies, raw


def _both_mapped(genomes=None):
    genomes = genomes or _genomes()
    jax_side = _mapped(j_seq, j_esa, j_stats, j_map, j_progress, genomes)
    port_side = _mapped(t_seq, t_esa, t_stats, t_map, t_progress, genomes)
    return jax_side, port_side


def case_suffix_array(tmp_path):
    rng = np.random.default_rng(11)
    text = ACGT[rng.integers(0, 4, 20_001)]
    text[::997] = ord("!")
    assert np.array_equal(t_native.build_sa(text), j_native.build_sa(text))
    for backend in ("native", "numpy"):
        seq = _genomes(length=3000)[-1]
        ours = t_esa.ESAIndex(t_seq.Sequence("s", seq), backend=backend)
        theirs = j_esa.ESAIndex(j_seq.Sequence("s", seq), backend=backend)
        assert ours.backend_name == theirs.backend_name == backend
        assert ours.size == theirs.size
        assert np.array_equal(np.asarray(ours.SA), np.asarray(theirs.SA))
        assert np.array_equal(np.asarray(ours.S), np.asarray(theirs.S))


def _index_at_threads(nt: int):
    """At ``nt`` native threads, the port's index over a doubled 1.2 Mbp
    text, whose SA and bucket tables are built in parallel, against the
    JAX package's serial build: the same SA, the same answers of the
    bucket-seeded probe, the same homologies mapped."""
    base, mutant, _, draft = _genomes(seed=21, n=4, length=600_000)
    theirs = j_esa.ESAIndex(j_seq.Sequence("G0", base), backend="native")
    t_native.set_threads(nt)
    try:
        ours = t_esa.ESAIndex(t_seq.Sequence("G0", base), backend="native")
    finally:
        t_native.set_threads(t_native.num_procs())
    assert ours._native.build_stats["threads"] == nt
    assert np.array_equal(np.asarray(ours.SA), np.asarray(theirs.SA))
    rng = np.random.default_rng(nt)
    q = np.frombuffer(mutant, np.uint8)
    for at, length in zip(rng.integers(0, len(q) - 200, 3000), rng.integers(1, 200, 3000)):
        window = q[at : at + length]
        assert ours._native.probe_unique(window) == theirs._native.probe_unique(window)
    threshold = t_stats.min_anchor_length(0.025, t_seq.gc_content(base), ours.size)
    for genome in (mutant, draft):
        mapped = ours.map_query(t_seq.Sequence("q", genome), threshold)
        assert mapped and _tuples(mapped) == _tuples(
            theirs.map_query(j_seq.Sequence("q", genome), threshold))


def case_index_one_thread(tmp_path):
    _index_at_threads(1)


def case_index_eight_threads(tmp_path):
    _index_at_threads(8)


def case_map_batch_native(tmp_path):
    (jref, jthr, _, jhv, jraw), (tref, tthr, _, thv, traw) = _both_mapped()
    assert tthr == jthr
    assert [_tuples(h) for h in thv] == [_tuples(h) for h in jhv]
    assert all(np.array_equal(a, b) for a, b in zip(traw, jraw))
    assert any(h.direction == t_hom.REVERSE for h in thv[-1])


def case_python_mapper(tmp_path):
    genomes = _genomes(length=3000)
    j_sub = j_seq.Sequence("G0", genomes[0])
    t_sub = t_seq.Sequence("G0", genomes[0])
    jref = j_esa.ESAIndex(j_sub, backend="numpy")
    tref = t_esa.ESAIndex(t_sub, backend="numpy")
    thr = t_stats.min_anchor_length(0.025, t_seq.gc_content(genomes[0]), tref.size)
    for g in genomes:
        ours = t_anchors.anchor_homologies(tref, thr, t_seq.Sequence("q", g))
        theirs = j_anchors.anchor_homologies(jref, thr, j_seq.Sequence("q", g))
        assert _tuples(ours) == _tuples(theirs)
        ours.sort(key=lambda h: h.start())
        theirs.sort(key=lambda h: h.start())
        assert (_tuples(t_filter.filter_overlaps_max(ours))
                == _tuples(j_filter.filter_overlaps_max(theirs)))


def case_read_genome(tmp_path):
    files = write_panel(str(tmp_path))
    draft = tmp_path / "draft.fasta"
    draft.write_bytes(b">c1 first\nACGTNNacgt\n>c2\n\nGGCC-TTAA\r\n")
    for name in files + [str(draft)]:
        ours, theirs = t_fasta.read_genome(name), j_fasta.read_genome(name)
        assert ours.name == theirs.name
        assert [c.nucl for c in ours.contigs] == [c.nucl for c in theirs.contigs]
        assert [c.name for c in ours.contigs] == [c.name for c in theirs.contigs]
        assert t_seq.join(ours).nucl == j_seq.join(theirs).nucl
    broken = tmp_path / "broken.fasta"
    for body in (b">c1\nACGT\n>c3\n", b"no header\n", b">\nACGT\n"):
        broken.write_bytes(body)
        messages = []
        for fasta in (t_fasta, j_fasta):
            with pytest.raises(ValueError) as err:
                fasta.read_genome(str(broken))
            messages.append(str(err.value))
        assert messages[0] == messages[1], body


def case_sequence_compaction(tmp_path):
    for g in _genomes(seed=5, length=4001):
        ours, theirs = t_seq.Sequence("x", g), j_seq.Sequence("x", g)
        ours.compact()
        theirs.compact()
        assert ours.nucl == theirs.nucl == g
        assert np.array_equal(ours.codes_slice(17, 3999), theirs.codes_slice(17, 3999))
        assert t_seq.revcomp(g) == j_seq.revcomp(g)
        assert t_seq.gc_content(g) == j_seq.gc_content(g)
    raw = b"ACGTnxyz-\nRYKMacgt"
    assert t_seq.filter_nucl(raw) == j_seq.filter_nucl(raw)


def case_build_pileup_pack_states(tmp_path):
    (_, _, jq, jhv, _), (_, _, tq, thv, _) = _both_mapped()
    ref_len = len(jq[0])
    ours = t_pileup.build_pileup(tq, thv, ref_len)
    theirs = j_pileup.build_pileup(jq, jhv, ref_len)
    assert np.array_equal(ours, theirs)
    for n_pad, width in ((len(ours), None), (len(ours) + 3, 2512)):
        assert np.array_equal(t_shapes.pack_states(ours, n_pad, width),
                              j_shapes.pack_states(theirs, n_pad, width))


def case_pileup_prep(tmp_path):
    (_, _, jq, jhv, jraw), (_, _, tq, thv, traw) = _both_mapped()
    ref_len = len(jq[0])
    for a, b in zip(t_prep.group_payload(tq), j_prep.group_payload(jq)):
        assert np.array_equal(a, b)
    _, bases, seps = t_prep.group_payload(tq)
    for th, jh in ((thv, jhv), (traw, jraw)):
        ours = t_prep.prep_intervals(th, bases, ref_len)
        theirs = j_prep.prep_intervals(jh, bases, ref_len)
        assert np.array_equal(ours, theirs)
        for a, b in zip(t_prep.build_overlay(ours, tq, bases, seps, ref_len),
                        j_prep.build_overlay(theirs, jq, bases, seps, ref_len)):
            assert np.array_equal(a, b)


def case_pair_counts_host(tmp_path):
    rng = np.random.default_rng(21)
    states = rng.integers(0, 11, size=(9, 3001), dtype=np.uint8)
    states[4] = j_pileup.INVALID
    assert np.array_equal(t_table.MATCH_TABLE, j_table.MATCH_TABLE)
    for ours, theirs in (
        (t_bitplane.pair_counts_host(states), j_bitplane.pair_counts_host(states)),
        (t_table.pair_counts_numpy(states), j_table.pair_counts_numpy(states)),
    ):
        assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))


def case_pair_counts_windowed(tmp_path):
    genomes = _genomes()
    (_, _, _, _, jraw), (_, _, _, _, traw) = _both_mapped(genomes)
    ref_len = len(genomes[0])
    tq = [t_seq.Sequence(f"q{k}", g) for k, g in enumerate(genomes)]
    jq = [j_seq.Sequence(f"q{k}", g) for k, g in enumerate(genomes)]
    for q in tq + jq:
        q.compact()
    ours = t_lowmem.pair_counts_windowed(tq, traw, ref_len)
    theirs = j_lowmem.pair_counts_windowed(jq, jraw, ref_len)
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    assert t_lowmem.group_rows_for(1000, 10**6) == j_lowmem.group_rows_for(1000, 10**6)


def _counts(pkg_evo, seed=4, n=7):
    rng = np.random.default_rng(seed)
    homs = rng.integers(1000, 5000, size=(n, n)).astype(np.int64)
    homs = np.triu(homs, 1) + np.triu(homs, 1).T
    subs = (homs * rng.uniform(0.0, 0.3, size=(n, n))).astype(np.int64)
    subs = np.triu(subs, 1) + np.triu(subs, 1).T
    subs[0, 1] = subs[1, 0] = homs[0, 1]  # saturated: a NaN distance
    return pkg_evo.EvoCounts(subs, homs)


def case_estimate_print_matrix(tmp_path, monkeypatch):
    monkeypatch.setenv("PHYLONIUM_TPU_RD_SEED", "4242")
    names = [f"G{k}" for k in range(7)]
    lengths = np.arange(5000, 5007, dtype=np.int64)
    for dist in ("jc", "raw", "ani"):
        assert np.array_equal(t_phylip.estimate(_counts(t_evo), dist),
                              j_phylip.estimate(_counts(j_evo), dist), equal_nan=True)
        for bootstrap in (0, 3):
            outs = []
            for cfg, phylip, evo in ((t_config.RunConfig(), t_phylip, t_evo),
                                     (j_config.RunConfig(), j_phylip, j_evo)):
                cfg.distance, cfg.dist_ani, cfg.bootstrap = dist, dist == "ani", bootstrap
                buf = io.StringIO()
                with contextlib.redirect_stderr(io.StringIO()):
                    phylip.print_matrix(cfg, names, lengths, _counts(evo), 0, out=buf)
                outs.append(buf.getvalue())
            assert outs[0] == outs[1]
            assert outs[0].count("\n") == (1 + bootstrap) * 8


_ARGVS = [
    ["a.fa", "b.fa"],
    ["-2v", "-b5", "--distance=ani", "a", "b"],
    ["--boot", "3", "--dist", "raw", "--distance", "ani", "a", "b"],
    ["-b", "0", "a", "b"],
    ["-b", "-1", "a", "b"],
    ["-b", "junk", "a", "b"],
    ["--distance", "bogus", "a", "b"],
    ["-p", "pos.txt", "-r", "b", "a"],
    ["--progress", "a", "b"],
    ["--progress=sometimes", "a", "b"],
    ["-t", "1", "a", "b"],
    ["-t", "99999999", "a", "b"],
    ["-t", "x", "a", "b"],
    ["--esa-backend=numpy", "--count-backend", "host", "--map-backend=hybrid", "a", "b"],
    ["--esa-backend=bogus", "--count-backend=bogus", "--map-backend=bogus", "a", "b"],
    ["--mesh=2,2", "--mesh", "0", "--checkpoint", "ck", "--profile=pr", "a", "b"],
    ["-vv", "--complete-deletion", "--", "-x", "--y"],
    ["--nosuch", "a"],
    ["--c", "a"],
    ["-q", "a"],
    ["-r"],
    ["-h"],
    ["--he"],
    ["--version"],
    ["--vers", "a"],
]

_FIELDS = [f for f in t_config.RunConfig.__dataclass_fields__ if not f.startswith("_")]


def _parse(cli, argv):
    out, err = io.StringIO(), io.StringIO()
    code = cfg = files = None
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            cfg, files = cli.parse_args(list(argv))
        except SystemExit as e:
            code = e.code
    text = (out.getvalue() + "|" + err.getvalue()).replace(cli.USAGE, "<usage>")
    return cfg, files, code, text


def _version_text(cli) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
        cli.version()
    return out.getvalue()


def case_parse_args(tmp_path):
    for argv in _ARGVS:
        tcfg, tfiles, tcode, ttext = _parse(t_cli, argv)
        jcfg, jfiles, jcode, jtext = _parse(j_cli, argv)
        ttext = ttext.replace(_version_text(t_cli), "<version>")
        jtext = jtext.replace(_version_text(j_cli), "<version>")
        assert (tcode, tfiles) == (jcode, jfiles), argv
        assert ttext.replace(t_config.PROG, "<prog>") == jtext.replace(j_config.PROG, "<prog>"), argv
        if jcfg is not None:
            assert {f: getattr(tcfg, f) for f in _FIELDS} == {f: getattr(jcfg, f) for f in _FIELDS}, argv
    assert t_cli.cleanup_names("b", ["c", "b", "a"]) == j_cli.cleanup_names("b", ["c", "b", "a"])


def case_reference_pick(tmp_path):
    rng = np.random.default_rng(8)
    for trial in range(20):
        lengths = rng.integers(1, 6, size=int(rng.integers(2, 12)))
        seqs = [b"A" * int(n) for n in lengths]
        tq = [t_seq.Sequence(f"s{k}", s) for k, s in enumerate(seqs)]
        jq = [j_seq.Sequence(f"s{k}", s) for k, s in enumerate(seqs)]
        assert t_pick.pick_first_pass(tq) == j_pick.pick_first_pass(jq)
        assert (t_pick.pick_second_pass(_counts(t_evo, seed=trial))
                == j_pick.pick_second_pass(_counts(j_evo, seed=trial)))


def case_complete_deletion_refpos(tmp_path):
    (_, _, jq, jhv, _), (tref, _, tq, thv, _) = _both_mapped()
    ours = t_cd.complete_delete(thv)
    theirs = j_cd.complete_delete(jhv)
    assert [_tuples(h) for h in ours] == [_tuples(h) for h in theirs]
    assert ours[0]
    ref_len = len(tq[0])
    states = t_pileup.build_pileup(tq, ours, ref_len)
    t_seg.write_refpos(str(tmp_path / "t.pos"), tref.subject.nucl, states, ours[0])
    j_seg.write_refpos(str(tmp_path / "j.pos"), tref.subject.nucl, states, theirs[0])
    assert (tmp_path / "t.pos").read_bytes() == (tmp_path / "j.pos").read_bytes()


def case_checkpoint_round_trip(tmp_path):
    (_, jthr, _, jhv, _), (_, tthr, _, thv, _) = _both_mapped()
    skey = t_ckpt.subject_key(b"ACGT" * 10, tthr)
    assert skey == j_ckpt.subject_key(b"ACGT" * 10, jthr)
    key = t_ckpt.query_key(skey, "q", b"ACGTT")
    assert key == j_ckpt.query_key(skey, "q", b"ACGTT")
    ours = t_ckpt.MappingCheckpoint(str(tmp_path / "t"))
    theirs = j_ckpt.MappingCheckpoint(str(tmp_path / "j"))
    assert ours.load(key) is None
    ours.save(key, thv[-1])
    theirs.save(key, jhv[-1])
    assert _tuples(ours.load(key)) == _tuples(thv[-1])
    # each reads what the other wrote
    assert _tuples(j_ckpt.MappingCheckpoint(str(tmp_path / "t")).load(key)) == _tuples(jhv[-1])
    assert _tuples(t_ckpt.MappingCheckpoint(str(tmp_path / "j")).load(key)) == _tuples(thv[-1])
    assert np.array_equal(t_hom.to_arrays(thv[-1]), j_hom.to_arrays(jhv[-1]))


CASES = {
    name[len("case_"):]: fn for name, fn in globals().items() if name.startswith("case_")
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_host_copy_equals_jax(name, tmp_path, monkeypatch):
    fn = CASES[name]
    if "monkeypatch" in fn.__code__.co_varnames[: fn.__code__.co_argcount]:
        fn(tmp_path, monkeypatch)
    else:
        fn(tmp_path)


def test_native_library_builds_in_the_port():
    path = t_native.get_lib()._name
    assert os.path.dirname(path).endswith(os.path.join("phylonium_tpu_torch", "native", "_build"))
