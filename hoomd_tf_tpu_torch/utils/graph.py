"""CG graph analysis: DSGPM-JSON mappings to CG bonds, angles and
dihedrals (PyTorch port of ``hoomd_tf_tpu/utils/graph.py``, the
reference's ``utils.py:340-624``). Host-side numpy and json; the JAX
package's networkx shortest paths are written out here (a breadth-first
search and networkx's path enumeration, in its order), so the port needs
no graph library.
"""

import json

import numpy as np

__all__ = ["find_cgnode_id", "compute_adj_mat", "compute_cg_graph",
           "mol_features_multiple"]


def find_cgnode_id(atm_id, cg):
    """Index of the CG bead that holds atom ``atm_id`` in a DSGPM
    ``cgnodes`` list of lists (the reference's ``utils.py:340-354``)."""
    for bead_idx, members in enumerate(cg):
        if atm_id in members:
            return bead_idx
    return None


def compute_adj_mat(obj):
    """Adjacency matrix of a DSGPM mapping dict (the reference's
    ``utils.py:415-434``)."""
    cg = obj["cgnodes"]
    adj = np.zeros((len(cg), len(cg)))
    for edge in obj["edges"]:
        s = find_cgnode_id(int(edge["source"]), cg)
        t = find_cgnode_id(int(edge["target"]), cg)
        if s != t:
            adj[s, t] = adj[t, s] = 1
    return adj


def _neighbors(adj):
    """Each node's neighbors, ascending (networkx's adjacency order for a
    graph made from a numpy matrix)."""
    adj = np.asarray(adj)
    return [list(np.nonzero(adj[i])[0]) for i in range(adj.shape[0])]


def _predecessors(nbrs, source):
    """Breadth-first predecessor lists from ``source`` and each reached
    node's distance (``networkx.predecessor``)."""
    level, nextlevel = 0, [source]
    seen, pred = {source: 0}, {source: []}
    while nextlevel:
        level += 1
        thislevel, nextlevel = nextlevel, []
        for v in thislevel:
            for w in nbrs[v]:
                if w not in seen:
                    pred[w] = [v]
                    seen[w] = level
                    nextlevel.append(w)
                elif seen[w] == level:
                    pred[w].append(v)
    return pred, seen


def _all_shortest_paths(pred, source, target):
    """Every shortest path from ``source`` to ``target`` in networkx's
    order (``_build_paths_from_predecessors``)."""
    seen = {target}
    stack = [[target, 0]]
    top = 0
    while top >= 0:
        node, i = stack[top]
        if node == source:
            yield [p for p, _ in reversed(stack[:top + 1])]
        if len(pred[node]) > i:
            stack[top][1] = i + 1
            nxt = pred[node][i]
            if nxt in seen:
                continue
            seen.add(nxt)
            top += 1
            if top == len(stack):
                stack.append([nxt, 0])
            else:
                stack[top][:] = [nxt, 0]
        else:
            seen.discard(node)
            top -= 1


def compute_cg_graph(DSGPM=True, infile=None, adj_mat=None, cg_beads=None,
                     group_atoms=False, u_no_H=None, u_H=None):
    """Index tuples of the bonded, angle and dihedral CG beads of a CG
    mapping (the reference's ``utils.py:437-582``): bead pairs at graph
    distance 1 are bonds, 2 angles, 3 dihedrals, each tuple a shortest
    path between such a pair. With ``group_atoms=True`` also the CG
    coordinates as centers of mass (two MDAnalysis universes, with and
    without hydrogens).

    :return: ``(bond_idx [B, 2], angle_idx [A, 3], dihedral_idx [D, 4])``
        and, with ``group_atoms``, ``cg_positions [M, 3]``.
    """
    if DSGPM and infile is not None:
        with open(infile) as f:
            obj = json.load(f)
        cg = obj["cgnodes"]
        adj = compute_adj_mat(obj)
    elif not DSGPM and adj_mat is not None:
        adj = adj_mat
        cg = None
    else:
        print("correct inputs/flags are not given")
        return None

    nbrs = _neighbors(adj)
    preds = [_predecessors(nbrs, i) for i in range(len(nbrs))]
    pairs_by_dist = {1: set(), 2: set(), 3: set()}
    for i, (_, dist) in enumerate(preds):
        for j, d in dist.items():
            if d in pairs_by_dist:
                pairs_by_dist[d].add(tuple(sorted((i, int(j)))))

    def paths(pairs):
        out = []
        for a, b in sorted(pairs):
            out.extend(_all_shortest_paths(preds[a][0], a, b))
        return np.asarray(out)

    rs = paths(pairs_by_dist[1])
    angs = paths(pairs_by_dist[2])
    dihs = paths(pairs_by_dist[3])

    if group_atoms:
        if u_no_H is None or u_H is None:
            print("One or both MDAnalysis universe not specified")
            return rs, angs, dihs
        cg_positions = []
        for members in cg:
            group = None
            for atm_id in members:
                atom = u_no_H.atoms[atm_id]
                name, resid = str(atom.name), str(atom.resid)
                heavy = u_H.select_atoms(
                    f"name {name} and resid {resid}")
                hydro = u_H.select_atoms(
                    f"type H and bonded name {name} and resid {resid}")
                sel = heavy + hydro if len(list(hydro)) else heavy
                group = sel if group is None else group + sel
            cg_positions.append(group.center_of_mass())
        return rs, angs, dihs, np.asarray(cg_positions)

    print("CG coordinates are not calculated. "
          "Only connectivities are calculated")
    return rs, angs, dihs


def mol_features_multiple(bnd_indices=None, ang_indices=None,
                          dih_indices=None, molecules=None, beads=None):
    """Tile one molecule's feature index tuples across ``molecules``
    copies of ``beads`` beads each (the reference's ``utils.py:585-624``).

    :return: ``(bond_ids [?, 2], angle_ids [?, 3], dihedral_ids [?, 4])``.
    """
    def tile(indices, width):
        if indices is None:
            return np.zeros((0, width), dtype=np.int64)
        offs = np.arange(molecules)[:, None, None] * beads
        return (np.asarray(indices)[None] + offs).reshape(-1, width)

    return tile(bnd_indices, 2), tile(ang_indices, 3), tile(dih_indices, 4)
