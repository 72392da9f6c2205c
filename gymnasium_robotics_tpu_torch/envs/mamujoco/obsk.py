"""Kinematic-graph factorization for multi-agent MuJoCo (port of
gymnasium_robotics_tpu/envs/mamujoco/obsk.py: ``Node``, ``HyperEdge``,
``get_joints_at_kdist`` :42, ``build_obs`` :98-156 with its transforms
:68, ``get_parts_and_edges`` :158-454 and ``local_categories_for`` :455).

Nodes carry static qpos/qvel/actuator ids; hyperedges define joint
adjacency; ``get_joints_at_kdist`` is the same breadth-first search. Where
the JAX package runs each agent's observation as a program of gathers per
env, the port writes it down once, at construction, as a list of
(segment, row) entries (``obs_layout``, in ``build_obs``'s order, with its
body dedup and negative ids resolved against nq and nv); ``ObsGather``
then forms every agent's observation of a batch-last Data with one gather
from the concatenated segments (qpos, qvel, their clipped, sine and
cosine forms, the per-body rows, the tendon's), (B, n_i) per agent.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Node:
    label: str
    qpos_ids: Optional[int]
    qvel_ids: Optional[int]
    act_ids: Optional[int]
    bodies: Tuple[int, ...] = ()
    extra_obs: Tuple[Tuple[str, Tuple], ...] = ()  # (category, transform-spec)
    body_clip: bool = False  # ant: clip body categories to [-1, 1]

    def get_extra(self, category):
        for cat, spec in self.extra_obs:
            if cat == category:
                return spec
        return None


@dataclasses.dataclass(frozen=True)
class HyperEdge:
    nodes: Tuple[str, ...]  # node labels


def get_joints_at_kdist(
    partition: Tuple[Node, ...], edges: List[HyperEdge], k: int,
    all_nodes: Dict[str, Node],
) -> Dict[int, List[Node]]:
    """Breadth-first search over hyperedges: the nodes first reached at
    each depth up to k, sorted by label (the JAX obsk.get_joints_at_kdist)."""

    def adjacent(labels):
        out = set()
        for e in edges:
            if any(l in e.nodes for l in labels):
                out |= set(e.nodes) - set(labels)
        return out

    seen = {n.label for n in partition}
    k_dict = {0: sorted(seen)}
    frontier = set(seen)
    for depth in range(1, k + 1):
        new = adjacent(frontier) - seen
        k_dict[depth] = sorted(new)
        seen |= new
        frontier = frontier | new
    return {
        d: [all_nodes[l] for l in labels] for d, labels in k_dict.items()
    }


MANY_SEGMENT = ("ManySegmentSwimmer", "ManySegmentAnt")
MANY_SEGMENT_LATER = ("{}: its models are generated for each agent_conf at "
                      "construction; they come with the next slice of the "
                      "port (ROADMAP A.7)")
# rows a body contributes to each per-body category
BODY_ROWS = {"cinert": 10, "cvel": 6, "cfrc_ext": 6}


def _transform_rows(spec, nq: int, nv: int, index_only: bool):
    """The (segment, row) entries of an ``extra_obs`` transform (the JAX
    obsk._apply_transform); with ``index_only`` the clip is left out, as
    there."""
    kind = spec[0]
    if kind == "empty":
        return []
    if kind == "clip_qvel":
        key = "qvel" if index_only else ("clip_qvel", spec[2], spec[3])
        return [(key, int(i) % nv) for i in np.atleast_1d(spec[1])]
    if kind == "qpos_slice":
        return [("qpos", i) for i in range(nq)[spec[1]:spec[2]]]
    if kind == "qvel_slice":
        return [("qvel", i) for i in range(nv)[spec[1]:spec[2]]]
    if kind == "sincos_qpos":
        return [("sin_qpos", spec[1] % nq), ("cos_qpos", spec[1] % nq)]
    if kind == "qvel_pair":
        return [("qvel", spec[1] % nv), ("qvel", spec[2] % nv)]
    if kind == "body_dist":
        return [(("body_dist", spec[1], spec[2]), r) for r in range(3)]
    if kind == "body_xpos":
        return [("xpos", 3 * spec[1] + r) for r in range(3)]
    if kind == "ten_J_cols":
        return [("ten_J", spec[1] * nv + c) for c in spec[2]]
    if kind == "ten_length":
        return [("ten_length", spec[1])]
    if kind == "ten_velocity":
        return [("ten_velocity", spec[1])]
    raise ValueError(f"unknown transform {kind}")


def obs_layout(k_dict, local_categories, global_nodes, global_categories,
               nq: int, nv: int, index_only: bool = False):
    """One agent's observation as (segment, row) entries, in the order of
    the JAX obsk.build_obs: the nodes by depth, each category of its depth,
    then the global nodes by category; a body's rows once a category (the
    local and the global passes apart); clipped per-body rows for nodes
    with ``body_clip`` but with ``index_only``."""
    out = []
    body_seen: Dict[str, set] = {}

    def emit(node, category):
        spec = node.get_extra(category)
        if spec is not None:
            out.extend(_transform_rows(spec, nq, nv, index_only))
        elif category == "qvel":
            out.append(("qvel", node.qvel_ids % nv))
        elif category == "qpos":
            out.append(("qpos", node.qpos_ids % nq))
        elif category == "qfrc_actuator":
            out.append(("qfrc_actuator", node.qvel_ids % nv))
        elif category in BODY_ROWS:
            seen = body_seen.setdefault(category, set())
            key = (("clip1", category) if node.body_clip and not index_only
                   else category)
            w = BODY_ROWS[category]
            for body in node.bodies:
                if body in seen:
                    continue
                seen.add(body)
                out.extend((key, body * w + r) for r in range(w))
        # ten_J, ten_length, ten_velocity, fingertip_dist: only through
        # extra_obs specs

    for k in sorted(k_dict.keys()):
        for node in k_dict[k]:
            for category in local_categories[k]:
                emit(node, category)
    body_seen.clear()
    for category in global_categories:
        for node in global_nodes:
            emit(node, category)
    return out


def segment(data, key):
    """A segment's rows of a batch-last Data, (n, B)."""
    name = key if isinstance(key, str) else key[0]
    if name in ("qpos", "qvel", "qfrc_actuator", "ten_length", "ten_velocity"):
        return getattr(data, name)
    if name in ("cinert", "cvel", "cfrc_ext", "xpos", "ten_J"):
        x = getattr(data, name)
        return x.reshape(-1, x.shape[-1])
    if name == "clip_qvel":
        return torch.clamp(data.qvel, key[1], key[2])
    if name == "clip1":
        x = getattr(data, key[1])
        return torch.clamp(x.reshape(-1, x.shape[-1]), -1.0, 1.0)
    if name == "sin_qpos":
        return torch.sin(data.qpos)
    if name == "cos_qpos":
        return torch.cos(data.qpos)
    if name == "body_dist":
        return data.xpos[key[1]] - data.xpos[key[2]]
    raise ValueError(f"unknown segment {key}")


class ObsGather:
    """Every agent's observation as one gather: the layouts' segments
    (sized on ``sample``, a batch-last Data) concatenated in a fixed order
    and one index table over them, built once. Called on a Data, it
    returns the agents' (B, n_i) observations."""

    def __init__(self, layouts, sample):
        self.keys = list(dict.fromkeys(k for lay in layouts for k, _ in lay))
        offset, n = {}, 0
        for k in self.keys:
            offset[k] = n
            rows = segment(sample, k).shape[0]
            assert all(r < rows for kk, r in (e for lay in layouts for e in lay)
                       if kk == k), f"segment {k}: a row past its {rows}"
            n += rows
        dev = sample.qpos.device
        self.index = torch.tensor([offset[k] + r for lay in layouts for k, r in lay],
                                  dtype=torch.int64, device=dev)
        self.sizes = [len(lay) for lay in layouts]

    def __call__(self, data):
        B = data.qpos.shape[-1]
        if not self.keys:
            return [data.qpos.new_zeros((B, 0)) for _ in self.sizes]
        src = torch.cat([segment(data, k) for k in self.keys])
        return torch.split(src[self.index].T.contiguous(), self.sizes, dim=1)


# ---------------------------------------------------------------------------
# Scenario graphs (topologies mirror the JAX obsk :158-454; negative
# qpos/qvel ids index from the end exactly as there)
# ---------------------------------------------------------------------------

def get_parts_and_edges(label: str, partitioning: Optional[str]):
    """(partitions, edges, global nodes, nodes by label) of a scenario
    and agent_conf (the JAX obsk.get_parts_and_edges :158-454).
    ManySegmentSwimmer and ManySegmentAnt raise: their models are generated
    at construction, which the next slice of the port brings."""
    if label == "HalfCheetah":
        names = ["bthigh", "bshin", "bfoot", "fthigh", "fshin", "ffoot"]
        nodes = {
            n: Node(n, -6 + i, -6 + i, i) for i, n in enumerate(names)
        }
        edges = [
            HyperEdge(("bfoot", "bshin")), HyperEdge(("bshin", "bthigh")),
            HyperEdge(("bthigh", "fthigh")), HyperEdge(("fthigh", "fshin")),
            HyperEdge(("fshin", "ffoot")),
        ]
        globals_ = [
            Node("root_x", 0, 0, None, extra_obs=((("qpos", ("empty",))),)),
            Node("root_z", 1, 1, None),
            Node("root_y", 2, 2, None),
        ]
        parts = {
            None: [tuple(names)],
            "2x3": [("bthigh", "bshin", "bfoot"), ("fthigh", "fshin", "ffoot")],
            "6x1": [(n,) for n in names],
        }[partitioning]
    elif label == "Ant":
        torso, fll, aux1, ank1, frl, aux2, ank2, bl, aux3, ank3, brl, aux4, ank4 = \
            1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13
        spec = [
            ("hip1", -8, 2, (torso, fll)), ("ankle1", -7, 3, (fll, aux1, ank1)),
            ("hip2", -6, 4, (torso, frl)), ("ankle2", -5, 5, (frl, aux2, ank2)),
            ("hip3", -4, 6, (torso, bl)), ("ankle3", -3, 7, (bl, aux3, ank3)),
            ("hip4", -2, 0, (torso, brl)), ("ankle4", -1, 1, (brl, aux4, ank4)),
        ]
        nodes = {
            n: Node(n, q, q, a, bodies=b, body_clip=True)
            for n, q, a, b in spec
        }
        edges = [
            HyperEdge(("ankle4", "hip4")), HyperEdge(("ankle1", "hip1")),
            HyperEdge(("ankle2", "hip2")), HyperEdge(("ankle3", "hip3")),
            HyperEdge(("hip4", "hip1", "hip2", "hip3")),
        ]
        globals_ = [
            Node("root", 0, 0, None, extra_obs=(
                ("qpos", ("qpos_slice", 2, 7)),
                ("qvel", ("qvel_slice", 0, 6)),
            )),
        ]
        parts = {
            None: [tuple(n for n, *_ in spec)],
            "2x4": [("hip1", "ankle1", "hip2", "ankle2"),
                    ("hip3", "ankle3", "hip4", "ankle4")],
            "2x4d": [("hip1", "ankle1", "hip4", "ankle4"),
                     ("hip2", "ankle2", "hip3", "ankle3")],
            "4x2": [("hip1", "ankle1"), ("hip2", "ankle2"),
                    ("hip3", "ankle3"), ("hip4", "ankle4")],
        }[partitioning]
    elif label == "Hopper":
        names = ["thigh_joint", "leg_joint", "foot_joint"]
        nodes = {
            n: Node(n, -3 + i, -3 + i, i,
                    extra_obs=(("qvel", ("clip_qvel", -3 + i, -10, 10)),))
            for i, n in enumerate(names)
        }
        edges = [HyperEdge(("foot_joint", "leg_joint")),
                 HyperEdge(("leg_joint", "thigh_joint"))]
        globals_ = [
            Node("root_x", 0, 0, None, extra_obs=(
                ("qpos", ("empty",)), ("qvel", ("clip_qvel", 0, -10, 10)))),
            Node("root_z", 1, 1, None,
                 extra_obs=(("qvel", ("clip_qvel", 1, -10, 10)),)),
            Node("root_y", 2, 2, None,
                 extra_obs=(("qvel", ("clip_qvel", 2, -10, 10)),)),
        ]
        parts = {
            None: [tuple(names)],
            "3x1": [(n,) for n in names],
        }[partitioning]
    elif label == "Walker2d":
        names = ["thigh_joint", "leg_joint", "foot_joint",
                 "thigh_left_joint", "leg_left_joint", "foot_left_joint"]
        nodes = {n: Node(n, -6 + i, -6 + i, i) for i, n in enumerate(names)}
        edges = [
            HyperEdge(("foot_joint", "leg_joint")),
            HyperEdge(("leg_joint", "thigh_joint")),
            HyperEdge(("foot_left_joint", "leg_left_joint")),
            HyperEdge(("leg_left_joint", "thigh_left_joint")),
            HyperEdge(("thigh_joint", "thigh_left_joint")),
        ]
        globals_ = [
            Node("root_x", 0, 0, None, extra_obs=(("qpos", ("empty",)),)),
            Node("root_z", 1, 1, None),
            Node("root_y", 2, 2, None),
        ]
        parts = {
            None: [tuple(names)],
            "2x3": [tuple(names[:3]), tuple(names[3:])],
        }[partitioning]
    elif label == "Swimmer":
        nodes = {
            "rot2": Node("rot2", -2, -2, 0,
                         extra_obs=(("qvel", ("qvel_pair", 0, 3)),)),
            "rot3": Node("rot3", -1, -1, 1,
                         extra_obs=(("qvel", ("qvel_pair", 1, 4)),)),
        }
        edges = [HyperEdge(("rot2", "rot3"))]
        globals_ = [Node("free_body_rot", 2, 2, None)]
        parts = {
            None: [("rot2", "rot3")],
            "2x1": [("rot2",), ("rot3",)],
        }[partitioning]
    elif label == "Reacher":
        nodes = {
            "joint0": Node("joint0", -4, -4, 0, bodies=(1, 2),
                           extra_obs=(("qpos", ("sincos_qpos", -4)),)),
            "joint1": Node("joint1", -3, -3, 1, bodies=(2, 3),
                           extra_obs=(
                               ("fingertip_dist", ("body_dist", 3, 4)),
                               ("qpos", ("sincos_qpos", -3)),
                           )),
        }
        edges = [HyperEdge(("joint0", "joint1"))]
        globals_ = [
            Node("target_x", -2, -2, None, extra_obs=(("qvel", ("empty",)),)),
            Node("target_y", -1, -1, None, extra_obs=(("qvel", ("empty",)),)),
        ]
        parts = {
            None: [("joint0", "joint1")],
            "2x1": [("joint0",), ("joint1",)],
        }[partitioning]
    elif label in ("Humanoid", "HumanoidStandup"):
        # bodies (obsk.py:467-604)
        torso, lwaist, pelvis = 1, 2, 3
        rthigh, rsin, rfoot = 4, 5, 6
        lthigh, lsin, lfoot = 7, 8, 9
        ruarm, rlarm, luarm, llarm = 10, 11, 12, 13
        spec = [
            ("abdomen_y", -17, 0, (torso, lwaist, pelvis)),
            ("abdomen_z", -16, 1, (torso, lwaist, pelvis)),
            ("abdomen_x", -15, 2, (pelvis, rthigh, lthigh)),
            ("right_hip_x", -14, 3, (rthigh, rsin)),
            ("right_hip_z", -13, 4, (rthigh, rsin)),
            ("right_hip_y", -12, 5, (rthigh, rsin)),
            ("right_knee", -11, 6, (rsin, rfoot)),
            ("left_hip_x", -10, 7, (lthigh, lsin)),
            ("left_hip_z", -9, 8, (lthigh, lsin)),
            ("left_hip_y", -8, 9, (lthigh, lsin)),
            ("left_knee", -7, 10, (lsin, lfoot)),
            ("right_shoulder1", -6, 11, (torso, ruarm, rlarm)),
            ("right_shoulder2", -5, 12, (torso, ruarm, rlarm)),
            ("right_elbow", -4, 13, (rlarm,)),
            ("left_shoulder1", -3, 14, (torso, luarm, llarm)),
            ("left_shoulder2", -2, 15, (torso, luarm, llarm)),
            ("left_elbow", -1, 16, (llarm,)),
        ]
        nodes = {n: Node(n, q, q, a, bodies=b) for n, q, a, b in spec}
        abd = ("abdomen_x", "abdomen_y", "abdomen_z")
        rhip = ("right_hip_x", "right_hip_y", "right_hip_z")
        lhip = ("left_hip_x", "left_hip_y", "left_hip_z")
        edges = [
            HyperEdge(abd), HyperEdge(rhip), HyperEdge(lhip),
            HyperEdge(("left_elbow", "left_shoulder1", "left_shoulder2")),
            HyperEdge(("right_elbow", "right_shoulder1", "right_shoulder2")),
            HyperEdge(("left_knee",) + lhip),
            HyperEdge(("right_knee",) + rhip),
            HyperEdge(("left_shoulder1", "left_shoulder2") + abd),
            HyperEdge(("right_shoulder1", "right_shoulder2") + abd),
            HyperEdge(abd + lhip),
            HyperEdge(abd + rhip),
        ]
        globals_ = [
            Node("root", None, None, None, extra_obs=(
                ("qpos", ("qpos_slice", 2, 7)),
                ("qvel", ("qvel_slice", 0, 6)),
            )),
        ]
        upper = abd + ("right_shoulder1", "right_shoulder2", "right_elbow",
                       "left_shoulder1", "left_shoulder2", "left_elbow")
        lower = rhip + ("right_knee",) + lhip + ("left_knee",)
        parts = {
            None: [tuple(n for n, *_ in spec)],
            "9|8": [upper, lower],
        }[partitioning]
    elif label == "Pusher":
        # obsk.py:677-756
        names = ["r_shoulder_pan_joint", "r_shoulder_lift_joint",
                 "r_upper_arm_roll_joint", "r_elbow_flex_joint",
                 "r_forearm_roll_joint", "r_wrist_flex_joint",
                 "r_wrist_roll_joint"]
        nodes = {n: Node(n, i, i, i) for i, n in enumerate(names)}
        edges = [HyperEdge((names[i], names[i + 1])) for i in range(6)]
        globals_ = [
            Node("tips_arm", None, None, None, extra_obs=(
                ("qpos", ("body_xpos", 10)), ("qvel", ("empty",)))),
            Node("object", None, None, None, extra_obs=(
                ("qpos", ("body_xpos", 11)), ("qvel", ("empty",)))),
            Node("goal", None, None, None, extra_obs=(
                ("qpos", ("body_xpos", 12)), ("qvel", ("empty",)))),
        ]
        parts = {
            None: [tuple(names)],
            # Shoulder / Elbow / Wrist (obsk.py Pusher "3p")
            "3p": [tuple(names[:3]), (names[3],), tuple(names[4:])],
        }[partitioning]
    elif label == "CoupledHalfCheetah":
        # obsk.py:842-936. Note the reference gives BOTH cheetahs' joint nodes
        # the same negative ids (-6..-1, i.e. the SECOND cheetah's qpos/qvel);
        # mirrored verbatim for behavior parity. Only the bthigh nodes carry
        # the tendon observations.
        ten = (
            ("ten_J", ("ten_J_cols", 0, (0, 1, 9, 10))),
            ("ten_length", ("ten_length", 0)),
            ("ten_velocity", ("ten_velocity", 0)),
        )
        names0 = ["bthigh0", "bshin0", "bfoot0", "fthigh0", "fshin0", "ffoot0"]
        names1 = ["bthigh1", "bshin1", "bfoot1", "fthigh1", "fshin1", "ffoot1"]
        nodes = {}
        for base, names in ((0, names0), (6, names1)):
            for i, n in enumerate(names):
                nodes[n] = Node(
                    n, -6 + i, -6 + i, base + i,
                    extra_obs=ten if n.startswith("bthigh") else (),
                )
        edges = []
        for names in (names0, names1):
            b, s, f, ft, fs, ff = names
            edges += [
                HyperEdge((f, s)), HyperEdge((s, b)), HyperEdge((b, ft)),
                HyperEdge((ft, fs)), HyperEdge((fs, ff)),
            ]
        globals_ = [
            Node("root_x0", 0, 0, None, extra_obs=(("qpos", ("empty",)),)),
            Node("root_y0", 2, 2, None),
            Node("root_z0", 1, 1, None),
            Node("root_x1", 9, 9, None, extra_obs=(("qpos", ("empty",)),)),
            Node("root_y1", 11, 11, None),
            Node("root_z1", 10, 10, None),
        ]
        parts = {
            None: [tuple(names0 + names1)],
            "1p1": [tuple(names0), tuple(names1)],
        }[partitioning]
    elif label in MANY_SEGMENT:
        raise NotImplementedError(MANY_SEGMENT_LATER.format(label))
    else:
        raise NotImplementedError(
            f"Scenario {label!r} factorization not yet implemented in this "
            "build (available: HalfCheetah, Ant, Hopper, Walker2d, Swimmer, "
            "Reacher, Humanoid, HumanoidStandup, Pusher, CoupledHalfCheetah)."
        )

    partitions = [tuple(nodes[n] for n in p) for p in parts]
    return partitions, edges, globals_, nodes


def local_categories_for(scenario: str, agent_obsk: int):
    """Default per-depth observation categories (mujoco_multi.py:581-615)."""
    if scenario in ("Ant", "ManySegmentAnt"):
        k_cat = [["qpos", "qvel", "cfrc_ext"], ["qpos"]]
    elif scenario in ("Humanoid", "HumanoidStandup"):
        k_cat = [["qpos", "qvel", "cinert", "cvel", "qfrc_actuator", "cfrc_ext"],
                 ["qpos"]]
    elif scenario == "CoupledHalfCheetah":
        k_cat = [["qpos", "qvel", "ten_J", "ten_length", "ten_velocity"], ["qpos"]]
    elif scenario == "Reacher":
        k_cat = [["qpos", "qvel", "fingertip_dist"], ["qpos"]]
    else:
        k_cat = [["qpos", "qvel"], ["qpos"]]
    return [k_cat[k if k < len(k_cat) else -1] for k in range(agent_obsk + 1)]
