"""Linear Integer Secret Sharing (LISS) over the t-of-n threshold access
structure, via monotone span programs.

Re-implementation (same math, fresh code) of the reference's threshold
keygen machinery in cpu_cryptosystem_distributed.inl:1-309 (which follows
Thesis-RIT §3.3.1 and eprint 2022/1143 Alg. 8). The distribution matrix is
built from AND/OR compositions of the trivial single-party program; each of
the C(n,t) threshold combinations gets an independent AND-chain, and party i
stores one share per combination containing it (sorted lexicographically —
the `sk_share_id` used on the wire is the lexicographic rank of the surviving
combination, see reference smpc_client.hpp:283-295).

Reconstruction for a combination: lambda = (1, -1, ..., -1), i.e.
secret = s_0 - s_1 - ... - s_{t-1}.
"""

from __future__ import annotations

from itertools import combinations

from .rng import RandGen


def _m_and(Ma: list[list[int]], Mb: list[list[int]]) -> list[list[int]]:
    da, ea = len(Ma), len(Ma[0])
    db, eb = len(Mb), len(Mb[0])
    M = [[0] * (ea + eb) for _ in range(da + db)]
    for i in range(da):
        M[i][0] = Ma[i][0]
        M[i][1] = Ma[i][0]
        for j in range(1, ea):
            M[i][j + 1] = Ma[i][j]
    for i in range(db):
        M[da + i][1] = Mb[i][0]
        for j in range(1, eb):
            M[da + i][ea + j] = Mb[i][j]
    return M


def _m_or(Ma: list[list[int]], Mb: list[list[int]]) -> list[list[int]]:
    da, ea = len(Ma), len(Ma[0])
    db, eb = len(Mb), len(Mb[0])
    M = [[0] * (ea + eb - 1) for _ in range(da + db)]
    for i in range(da):
        M[i][0] = Ma[i][0]
        for j in range(1, ea):
            M[i][j] = Ma[i][j]
    for i in range(db):
        M[da + i][0] = Mb[i][0]
        for j in range(1, eb):
            M[da + i][ea + j - 1] = Mb[i][j]
    return M


def distribution_matrix(n: int, t: int) -> list[list[int]]:
    """OR over C(n,t) combinations of an AND-chain of t single-party programs."""
    from math import comb

    Mu = [[1]]
    Mt = Mu
    for _ in range(1, t):
        Mt = _m_and(Mt, Mu)
    M = Mt
    for _ in range(1, comb(n, t)):
        M = _m_or(M, Mt)
    return M


def share_secret(secret: int, n: int, t: int, rho_bound: int, rand_gen: RandGen
                 ) -> list[list[int]]:
    """Returns per-party share lists: shares[party] = [s for each combination
    containing party, in lexicographic combination order].

    rho = (secret, r_2, ..., r_e) with r_i uniform in [0, rho_bound)."""
    from math import comb

    M = distribution_matrix(n, t)
    cols = len(M[0])
    rho = [secret] + [rand_gen.random_mpz(rho_bound) for _ in range(cols - 1)]
    # all shares in combination-major order: combination c uses rows c*t..c*t+t-1
    num_comb = comb(n, t)
    party_shares: list[list[int]] = [[] for _ in range(n)]
    row = 0
    for combo in combinations(range(n), t):
        for member in combo:
            s = sum(M[row][j] * rho[j] for j in range(cols))
            party_shares[member].append(s)
            row += 1
    return party_shares


def reconstruct(shares_for_combo: list[int]) -> int:
    """secret = s_0 - s_1 - ... - s_{t-1} (lambda = (1, -1, ..., -1))."""
    return shares_for_combo[0] - sum(shares_for_combo[1:])


def combination_rank(combo: tuple[int, ...], n: int) -> int:
    """Lexicographic rank of a sorted t-combination of range(n) — the wire
    `sk_share_id` (reference combinationSequenceNumber,
    smpc_client.hpp:283-295)."""
    from math import comb

    t = len(combo)
    rank = 0
    prev = -1
    for idx, c in enumerate(combo):
        for x in range(prev + 1, c):
            rank += comb(n - x - 1, t - idx - 1)
        prev = c
    return rank


def rank_indexed_shares(party_shares: list[list[int]], n: int, t: int) -> list[list[int]]:
    """Expand per-party share lists (one entry per combination containing the
    party, in lexicographic order) into C(n,t)-long rank-indexed lists where
    entry r is the party's share for combination rank r (0 when the party is
    not in that combination). This is the layout CoFHE nodes store so the
    wire `sk_share_id` (= combination rank) indexes directly."""
    from math import comb

    num = comb(n, t)
    out = [[0] * num for _ in range(n)]
    counters = [0] * n
    for r, combo in enumerate(combinations(range(n), t)):
        for member in combo:
            out[member][r] = party_shares[member][counters[member]]
            counters[member] += 1
    return out


def share_index_for_party(party: int, combo: tuple[int, ...], n: int) -> int:
    """Index into party's local share list for the given combination: the
    number of earlier lexicographic combinations containing `party`."""
    from math import comb

    t = len(combo)
    count = 0
    for c in combinations(range(n), t):
        if c == combo:
            break
        if party in c:
            count += 1
    return count
