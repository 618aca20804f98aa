"""Reference-format text serialization for HDP / NanoporeHDP.

Reads and writes the exact line-oriented layout of serialize_hdp /
deserialize_hdp (impl/hdp.c:2876-3278) and serialize_nhdp /
deserialize_nhdp (impl/nanopore_hdp.c:828-867), so HDP models produced by
the reference toolchain load here and models trained here can be consumed
by reference tools.  Numbers are written with %.17g (the reference's
%.17lg) for bit-level double round-trips.

Format (one item per line unless noted):
  splines_finalized, has_data, sample_gamma, num_dps
  [data values TSV; data dp_ids TSV]                (if has_data)
  mu nu alpha beta                                  (alpha = two_alpha/2)
  grid_start grid_stop grid_length
  gamma values TSV (depth entries)
  [gamma_alpha TSV; gamma_beta TSV; w TSV; s TSV]   (if sample_gamma)
  per-DP: "<parent_id or -> TAB <num_factor_children>"
  per-DP posterior-predictive TSV (empty if none)   (if has_data)
  per-DP spline-slope TSV (empty if none)           (if splines_finalized)
  factor lines "type TAB parent TAB extra"          (if has_data)
    type 0 BASE:    parent "-",   extra ";"-joined 5 NIG params
    type 1 MIDDLE:  extra = dp id
    type 2 DATA_PT: extra = data index
  (parents always precede children: pre-order per base-factor tree)
"""

import numpy as np

from .hdp import BASE, DATA_PT, MIDDLE, Factor, HierarchicalDirichletProcess


def _fmt_row(vals, fmt="{:.17g}"):
    return "\t".join(fmt.format(v) for v in vals)


def serialize_hdp_text(hdp, fh):
    """serialize_hdp (impl/hdp.c:2876-3001)."""
    if not hdp.finalized:
        raise ValueError("finalize HDP structure before serializing")
    has_data = hdp.data is not None
    w = fh.write
    w(f"{int(hdp.splines_finalized)}\n")
    w(f"{int(has_data)}\n")
    w(f"{int(hdp.sample_gamma)}\n")
    w(f"{hdp.num_dps}\n")
    if has_data:
        w(_fmt_row(hdp.data) + "\n")
        w(_fmt_row(hdp.data_pt_dp_id, fmt="{:d}") + "\n")
    w(_fmt_row([hdp.mu, hdp.nu, hdp.two_alpha / 2.0, hdp.beta]) + "\n")
    w("{:.17g}\t{:.17g}\t{:d}\n".format(hdp.sampling_grid[0],
                                        hdp.sampling_grid[-1],
                                        hdp.grid_length))
    w(_fmt_row(hdp.gamma) + "\n")
    if hdp.sample_gamma:
        w(_fmt_row(hdp.gamma_alpha) + "\n")
        w(_fmt_row(hdp.gamma_beta) + "\n")
        w(_fmt_row(hdp.w_aux) + "\n")
        w(_fmt_row(hdp.s_aux.astype(np.int64), fmt="{:d}") + "\n")
    for dp in hdp.dps:
        parent = "-" if dp is hdp.base_dp else str(dp.parent.id)
        w(f"{parent}\t{dp.num_factor_children}\n")
    if has_data:
        for dp in hdp.dps:
            pp = dp.posterior_predictive
            w(("" if pp is None else _fmt_row(pp)) + "\n")
    if hdp.splines_finalized:
        for dp in hdp.dps:
            ss = dp.spline_slopes
            w(("" if ss is None else _fmt_row(ss)) + "\n")
    if has_data:
        # pre-order per tree: parent ids always precede children
        # (serialize_factor_tree_internal, impl/hdp.c:2825-2874)
        next_id = [0]

        def visit(fctr, parent_id):
            fid = next_id[0]
            next_id[0] += 1
            if fctr.factor_type == BASE:
                extra = ";".join("{:.17g}".format(p) for p in fctr.params)
                w(f"0\t-\t{extra}\n")
            elif fctr.factor_type == MIDDLE:
                w(f"1\t{parent_id}\t{fctr.dp.id}\n")
            else:
                w(f"2\t{parent_id}\t{fctr.data_pt_idx}\n")
            if fctr.children:
                for child in fctr.children:
                    visit(child, fid)

        for fctr in hdp.base_dp.factors:
            visit(fctr, -1)


def deserialize_hdp_text(fh):
    """deserialize_hdp (impl/hdp.c:3009-3278)."""
    def line():
        s = fh.readline()
        if s == "":
            raise ValueError("truncated HDP text serialization")
        return s.rstrip("\n")

    splines_finalized = bool(int(line()))
    has_data = bool(int(line()))
    sample_gamma = bool(int(line()))
    num_dps = int(line())
    data = dp_ids = None
    if has_data:
        data = np.array([float(t) for t in line().split()])
        dp_ids = np.array([int(t) for t in line().split()], dtype=np.int64)
    mu, nu, alpha, beta = (float(t) for t in line().split())
    g0, g1, glen = line().split()
    grid_start, grid_stop, grid_length = float(g0), float(g1), int(glen)
    gamma = np.array([float(t) for t in line().split()])
    depth = len(gamma)
    kwargs = dict(grid_start=grid_start, grid_stop=grid_stop,
                  grid_length=grid_length, mu=mu, nu=nu, alpha=alpha,
                  beta=beta)
    if sample_gamma:
        gamma_alpha = np.array([float(t) for t in line().split()])
        gamma_beta = np.array([float(t) for t in line().split()])
        w_aux = np.array([float(t) for t in line().split()])
        s_aux = np.array([int(t) for t in line().split()], dtype=bool)
        hdp = HierarchicalDirichletProcess(
            num_dps, depth, gamma_alpha=gamma_alpha, gamma_beta=gamma_beta,
            **kwargs)
        hdp.gamma = gamma
        hdp.w_aux = w_aux
        hdp.s_aux = s_aux
    else:
        hdp = HierarchicalDirichletProcess(num_dps, depth, gamma=gamma,
                                           **kwargs)
    # dp parents + factor-children counts
    nfc = np.zeros(num_dps, dtype=np.int64)
    for dp_id in range(num_dps):
        ptok, ctok = line().split("\t")
        nfc[dp_id] = int(ctok)
        if ptok != "-":
            hdp.set_dir_proc_parent(dp_id, int(ptok))
    hdp.finalize_structure()
    for dp_id in range(num_dps):
        hdp.dps[dp_id].num_factor_children = int(nfc[dp_id])
    if has_data:
        # manual data restore (the reference skips pass_data to avoid
        # re-initializing factors, impl/hdp.c:3165-3177)
        hdp.data = data
        hdp.data_pt_dp_id = dp_ids
        for i in set(dp_ids.tolist()):
            dp = hdp.dps[i]
            if dp.children:
                raise ValueError("data assigned to a non-leaf DP")
            while dp is not None and not dp.observed:
                dp.observed = True
                dp = dp.parent
        for dp in hdp.dps:
            pp = line().split()
            if pp:
                dp.posterior_predictive = np.array([float(t) for t in pp])
            elif dp.observed:
                dp.posterior_predictive = np.zeros(grid_length)
    if splines_finalized:
        for dp in hdp.dps:
            ss = line().split()
            if ss:
                dp.spline_slopes = np.array([float(t) for t in ss])
        hdp.splines_finalized = True
    if has_data:
        factors = []
        for raw in fh:
            raw = raw.rstrip("\n")
            if not raw:
                continue
            tokens = raw.split("\t")
            ftype = int(tokens[0])
            if ftype == BASE:
                f = Factor(BASE, hdp.base_dp)
                f.params = [float(t) for t in tokens[2].split(";")]
            elif ftype == MIDDLE:
                f = Factor(MIDDLE, hdp.dps[int(tokens[2])])
            elif ftype == DATA_PT:
                f = Factor(DATA_PT)
                f.data_pt_idx = int(tokens[2])
            else:
                raise ValueError(f"bad factor type {ftype}")
            if tokens[1] != "-":
                parent = factors[int(tokens[1])]
                f.parent = parent
                parent.children.add(f)
            factors.append(f)
    return hdp


def serialize_nhdp_text(nhdp, path):
    """serialize_nhdp (impl/nanopore_hdp.c:828-838)."""
    with open(path, "w") as fh:
        fh.write(f"{nhdp.alphabet_size}\n")
        fh.write(f"{nhdp.alphabet}\n")
        fh.write(f"{nhdp.kmer_length}\n")
        serialize_hdp_text(nhdp.hdp, fh)


def deserialize_nhdp_text(path):
    """deserialize_nhdp (impl/nanopore_hdp.c:840-867)."""
    from .nanopore_hdp import NanoporeHDP
    with open(path) as fh:
        alphabet_size = int(fh.readline())
        alphabet = fh.readline().strip()
        if len(alphabet) != alphabet_size:
            raise ValueError("alphabet length mismatch")
        kmer_length = int(fh.readline())
        hdp = deserialize_hdp_text(fh)
    return NanoporeHDP(hdp, alphabet, kmer_length)
