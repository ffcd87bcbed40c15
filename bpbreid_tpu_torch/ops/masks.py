"""Human-parsing mask pipeline (port of bpbreid_tpu/ops/masks.py):
PifPaf channel grouping and background computation.

The reference implements channel grouping as per-part Python loops over
torch tensors (masks_transforms/mask_transform.py:21-38 and the 24 named
strategies in pifpaf_mask_transform.py). Here every strategy is compiled
once into a static ``[C, K]`` combination matrix; grouping then is a
single matmul (sum mode) or a broadcast-max (max mode) over channel-last
arrays, batched over N.

Masks are channel-first here (``[N, C, H, W]``).

Strategy tables reproduce the reference's semantic channel groupings
(pifpaf_mask_transform.py:6-535, coco_keypoints_transforms.py:3-21).
Two strategies are unusable in the reference due to latent bugs
('mu_sc' crashes on nested group names, 'six_no' passes a list where a
dict is expected); here nested references are resolved recursively and
'six_no' uses sum-combine as intended.
"""
from collections import OrderedDict

import numpy as np
import torch

__all__ = [
    'PIFPAF_KEYPOINTS', 'PIFPAF_JOINTS', 'PIFPAF_PARTS', 'COCO_KEYPOINTS',
    'GROUPING_STRATEGIES', 'get_grouping', 'grouping_matrix', 'group_masks',
    'add_background_mask', 'pcb_stripe_masks', 'identity_masks',
    'masks_preprocess_all', 'compute_parts_num_and_names',
]

PIFPAF_KEYPOINTS = [
    'nose', 'left_eye', 'right_eye', 'left_ear', 'right_ear',
    'left_shoulder', 'right_shoulder', 'left_elbow', 'right_elbow',
    'left_wrist', 'right_wrist', 'left_hip', 'right_hip', 'left_knee',
    'right_knee', 'left_ankle', 'right_ankle',
]

PIFPAF_JOINTS = [
    'left_ankle_to_left_knee', 'left_knee_to_left_hip',
    'right_ankle_to_right_knee', 'right_knee_to_right_hip',
    'left_hip_to_right_hip', 'left_shoulder_to_left_hip',
    'right_shoulder_to_right_hip', 'left_shoulder_to_right_shoulder',
    'left_shoulder_to_left_elbow', 'right_shoulder_to_right_elbow',
    'left_elbow_to_left_wrist', 'right_elbow_to_right_wrist',
    'left_eye_to_right_eye', 'nose_to_left_eye', 'nose_to_right_eye',
    'left_eye_to_left_ear', 'right_eye_to_right_ear',
    'left_ear_to_left_shoulder', 'right_ear_to_right_shoulder',
]

PIFPAF_PARTS = PIFPAF_KEYPOINTS + PIFPAF_JOINTS
COCO_KEYPOINTS = list(PIFPAF_KEYPOINTS)

# ---------------------------------------------------------------------------
# reusable semantic channel blocks
# ---------------------------------------------------------------------------
_HEAD_KP = ['nose', 'left_eye', 'right_eye', 'left_ear', 'right_ear']
_HEAD_JOINTS_INNER = ['left_eye_to_right_eye', 'nose_to_left_eye',
                      'nose_to_right_eye', 'left_eye_to_left_ear',
                      'right_eye_to_right_ear']
_NECK = ['left_ear_to_left_shoulder', 'right_ear_to_right_shoulder']
_HEAD = _HEAD_KP + _HEAD_JOINTS_INNER + _NECK

_LEFT_ARM = ['left_shoulder', 'left_elbow', 'left_wrist',
             'left_shoulder_to_left_elbow', 'left_elbow_to_left_wrist']
_RIGHT_ARM = ['right_shoulder', 'right_elbow', 'right_wrist',
              'right_shoulder_to_right_elbow', 'right_elbow_to_right_wrist']
_ARMS = _LEFT_ARM + _RIGHT_ARM
_ARMS_NO_SHOULDER = ['left_elbow', 'right_elbow', 'left_wrist', 'right_wrist',
                     'left_shoulder_to_left_elbow', 'right_shoulder_to_right_elbow',
                     'left_elbow_to_left_wrist', 'right_elbow_to_right_wrist']

_TORSO = ['left_hip', 'right_hip', 'left_hip_to_right_hip',
          'left_shoulder_to_left_hip', 'right_shoulder_to_right_hip',
          'left_shoulder_to_right_shoulder']
_TORSO_WITH_SHOULDERS = ['left_shoulder', 'right_shoulder'] + _TORSO
_UPPER_TORSO = ['left_shoulder_to_left_hip', 'right_shoulder_to_right_hip',
                'left_shoulder_to_right_shoulder']
_LOWER_TORSO = ['left_hip', 'right_hip', 'left_hip_to_right_hip']

_LEGS = ['left_hip', 'right_hip', 'left_knee', 'right_knee', 'left_ankle',
         'right_ankle', 'left_ankle_to_left_knee', 'left_knee_to_left_hip',
         'right_ankle_to_right_knee', 'right_knee_to_right_hip',
         'left_hip_to_right_hip']
_LEGS_NO_ANKLE = ['left_hip', 'right_hip', 'left_knee', 'right_knee',
                  'left_ankle_to_left_knee', 'left_knee_to_left_hip',
                  'right_ankle_to_right_knee', 'right_knee_to_right_hip']
_LEG_JOINTS = ['left_knee', 'left_ankle_to_left_knee', 'left_knee_to_left_hip',
               'left_hip_to_right_hip', 'right_knee',
               'right_ankle_to_right_knee', 'right_knee_to_right_hip']
_FEET = ['left_ankle', 'right_ankle']

_LEFT_LEG = ['left_knee', 'left_ankle', 'left_ankle_to_left_knee',
             'left_knee_to_left_hip', 'left_hip_to_right_hip']
_RIGHT_LEG = ['right_knee', 'right_ankle', 'right_ankle_to_right_knee',
              'right_knee_to_right_hip']
_LEFT_LEG_NO_ANKLE = ['left_knee', 'left_ankle_to_left_knee',
                      'left_knee_to_left_hip', 'left_hip_to_right_hip']
_RIGHT_LEG_NO_ANKLE = ['right_knee', 'right_ankle_to_right_knee',
                       'right_knee_to_right_hip']


class GroupingSpec:
    """A named mask-grouping strategy: ordered part -> channel list."""

    def __init__(self, name, groups, combine='max', source='pifpaf'):
        self.name = name
        self.combine = combine
        self.source = source
        channels = PIFPAF_PARTS if source == 'pifpaf' else COCO_KEYPOINTS
        chan_index = {c: i for i, c in enumerate(channels)}
        # resolve nested group references (a group may name another group)
        resolved = OrderedDict()
        for part, members in groups.items():
            out = []
            stack = list(members)
            while stack:
                m = stack.pop(0)
                if m in chan_index:
                    out.append(m)
                elif m in groups and m != part:
                    stack = list(groups[m]) + stack
                else:
                    raise KeyError('unknown channel or group: {}'.format(m))
            resolved[part] = out
        self.groups = resolved
        self.parts_names = list(resolved.keys())
        self.parts_num = len(self.parts_names)
        self.num_channels = len(channels)
        m = np.zeros((self.num_channels, self.parts_num), dtype=np.float32)
        for k, part in enumerate(self.parts_names):
            for c in resolved[part]:
                m[chan_index[c], k] = 1.0
        self.matrix = m


_PIFPAF_SINGLES = OrderedDict((k, [k]) for k in PIFPAF_PARTS)

_STRATEGY_TABLES = {
    'full': OrderedDict(full_body=PIFPAF_PARTS),
    'one': OrderedDict(full=PIFPAF_PARTS),
    'bs_fu': OrderedDict(**_PIFPAF_SINGLES, full_body=PIFPAF_PARTS),
    'mu_sc': OrderedDict(
        **_PIFPAF_SINGLES,
        head_mask=_HEAD,
        arms_mask=['left_shoulder', 'right_shoulder'] + _ARMS_NO_SHOULDER,
        torso_mask=_TORSO_WITH_SHOULDERS,
        legs_mask=_LEGS,
        feet_mask=_FEET,
        upper_body=['torso_mask', 'arms_mask', 'head_mask'],
        lower_body=['legs_mask', 'feet_mask'],
        full_body_mask=PIFPAF_PARTS,
    ),
    'two_v': OrderedDict(
        torso_arms_head=_HEAD + ['left_shoulder', 'right_shoulder',
                                 'left_shoulder_to_left_hip',
                                 'right_shoulder_to_right_hip',
                                 'left_shoulder_to_right_shoulder']
                        + _ARMS_NO_SHOULDER,
        legs=_LEGS,
    ),
    'three_v': OrderedDict(
        head_mask=_HEAD,
        torso_arms_mask=['left_shoulder', 'right_shoulder',
                         'left_shoulder_to_left_hip',
                         'right_shoulder_to_right_hip',
                         'left_shoulder_to_right_shoulder']
                        + _ARMS_NO_SHOULDER,
        legs_mask=_LEGS,
    ),
    'four': OrderedDict(
        head_mask=_HEAD,
        arms_mask=_ARMS,
        torso_mask=_TORSO_WITH_SHOULDERS,
        legs_mask=_LEGS,
    ),
    'four_no': OrderedDict(
        head_mask=_HEAD,
        arms_mask=_ARMS_NO_SHOULDER,
        torso_mask=_TORSO_WITH_SHOULDERS,
        legs_mask=['left_knee', 'right_knee', 'left_ankle', 'right_ankle',
                   'left_ankle_to_left_knee', 'left_knee_to_left_hip',
                   'right_ankle_to_right_knee', 'right_knee_to_right_hip',
                   'left_hip_to_right_hip'],
    ),
    'four_v': OrderedDict(
        head_mask=_HEAD,
        arms_torso_mask=_ARMS_NO_SHOULDER + _TORSO_WITH_SHOULDERS,
        legs_mask=_LEGS_NO_ANKLE,
        feet_mask=_FEET,
    ),
    'four_v_pif': OrderedDict(
        head_mask=_HEAD_KP,
        arms_torso_mask=['left_elbow', 'right_elbow', 'left_wrist',
                         'right_wrist', 'left_shoulder', 'right_shoulder',
                         'left_hip', 'right_hip'],
        legs_mask=['left_hip', 'right_hip', 'left_knee', 'right_knee'],
        feet_mask=_FEET,
    ),
    # the strategy used by all shipped BPBReID configs
    'five_v': OrderedDict(
        head_mask=_HEAD,
        upper_arms_torso_mask=['left_elbow', 'right_elbow',
                               'left_shoulder_to_left_elbow',
                               'right_shoulder_to_right_elbow',
                               'left_shoulder', 'right_shoulder',
                               'left_shoulder_to_right_shoulder'],
        lower_arms_torso_mask=['left_wrist', 'right_wrist',
                               'left_elbow_to_left_wrist',
                               'right_elbow_to_right_wrist',
                               'left_hip', 'right_hip',
                               'right_shoulder_to_right_hip'],
        legs_mask=_LEGS_NO_ANKLE,
        feet_mask=_FEET,
    ),
    'five': OrderedDict(
        head_mask=_HEAD,
        arms_mask=_ARMS,
        torso_mask=_TORSO,
        legs_mask=['left_hip_to_right_hip'] + _LEGS_NO_ANKLE,
        feet_mask=_FEET,
    ),
    'six': OrderedDict(
        head_mask=_HEAD,
        left_arm_mask=_LEFT_ARM,
        right_arm_mask=_RIGHT_ARM,
        torso_mask=_TORSO,
        left_leg_mask=_LEFT_LEG,
        right_leg_mask=_RIGHT_LEG,
    ),
    'six_v': OrderedDict(
        head_mask=_HEAD,
        arms_mask=_ARMS,
        upper_torso_mask=_UPPER_TORSO,
        lower_torso_mask=_LOWER_TORSO,
        legs_mask=_LEGS_NO_ANKLE,
        feet_mask=_FEET,
    ),
    'six_no': OrderedDict(
        head_mask=_HEAD,
        left_arm_mask=_LEFT_ARM,
        right_arm_mask=_RIGHT_ARM,
        torso_mask=_TORSO,
        left_leg_mask=_LEFT_LEG,
        right_leg_mask=_RIGHT_LEG,
    ),
    'six_new': OrderedDict(
        head_mask=_HEAD,
        torso_mask=_TORSO,
        left_arm_mask=_LEFT_ARM,
        right_arm_mask=_RIGHT_ARM,
        leg_mask=_LEG_JOINTS,
        feet_mask=_FEET,
    ),
    'seven_v': OrderedDict(
        head_mask=_HEAD,
        shoulders_mask=['left_shoulder', 'right_shoulder',
                        'left_shoulder_to_right_shoulder'],
        elbow_mask=['left_elbow', 'right_elbow'],
        wrist_mask=['left_wrist', 'right_wrist'],
        hip_mask=_LOWER_TORSO,
        knee_mask=['left_knee', 'right_knee'],
        ankle_mask=_FEET,
    ),
    'seven_new': OrderedDict(
        head_mask=_HEAD,
        left_arm_mask=_LEFT_ARM,
        right_arm_mask=_RIGHT_ARM,
        upper_torso_mask=_UPPER_TORSO,
        lower_torso_mask=_LOWER_TORSO,
        leg_mask=_LEG_JOINTS,
        feet_mask=_FEET,
    ),
    'eight': OrderedDict(
        head_mask=_HEAD,
        left_arm_mask=_LEFT_ARM,
        right_arm_mask=_RIGHT_ARM,
        torso_mask=_TORSO,
        left_leg_mask=_LEFT_LEG_NO_ANKLE,
        right_leg_mask=_RIGHT_LEG_NO_ANKLE,
        left_feet_mask=['left_ankle'],
        right_feet_mask=['right_ankle'],
    ),
    # 'eight_v' is defined identically to 'eight' in the reference
    # (pifpaf_mask_transform.py:378-400)
    'eight_v': OrderedDict(
        head_mask=_HEAD,
        left_arm_mask=_LEFT_ARM,
        right_arm_mask=_RIGHT_ARM,
        torso_mask=_TORSO,
        left_leg_mask=_LEFT_LEG_NO_ANKLE,
        right_leg_mask=_RIGHT_LEG_NO_ANKLE,
        left_feet_mask=['left_ankle'],
        right_feet_mask=['right_ankle'],
    ),
    'ten_ms': OrderedDict(
        head_mask=_HEAD,
        left_arm_mask=_LEFT_ARM,
        right_arm_mask=_RIGHT_ARM,
        torso_mask=_TORSO,
        left_leg_mask=_LEFT_LEG_NO_ANKLE,
        right_leg_mask=_RIGHT_LEG_NO_ANKLE,
        left_feet_mask=['left_ankle'],
        right_feet_mask=['right_ankle'],
        upper_body_mask=_HEAD + _ARMS + _TORSO,
        lower_body_mask=_LEG_JOINTS + _FEET,
    ),
    'eleven': OrderedDict(
        head_mask=_HEAD,
        left_elbow_mask=['left_shoulder', 'left_elbow',
                         'left_shoulder_to_left_elbow'],
        left_wrist_mask=['left_wrist', 'left_elbow_to_left_wrist'],
        right_elbow_mask=['right_shoulder', 'right_elbow',
                          'right_shoulder_to_right_elbow'],
        right_wrist_mask=['right_wrist', 'right_elbow_to_right_wrist'],
        upper_torso_mask=_UPPER_TORSO,
        lower_torso_mask=_LOWER_TORSO,
        left_leg_mask=['left_knee', 'left_knee_to_left_hip',
                       'left_hip_to_right_hip'],
        right_leg_mask=['right_knee', 'right_knee_to_right_hip'],
        left_feet_mask=['left_ankle_to_left_knee', 'left_ankle'],
        right_feet_mask=['right_ankle_to_right_knee', 'right_ankle'],
    ),
    'fourteen': OrderedDict(
        head_mask=_HEAD_KP + _HEAD_JOINTS_INNER,
        neck_mask=_NECK,
        left_elbow_mask=['left_shoulder', 'left_elbow',
                         'left_shoulder_to_left_elbow'],
        left_wrist_mask=['left_wrist', 'left_elbow_to_left_wrist'],
        right_elbow_mask=['right_shoulder', 'right_elbow',
                          'right_shoulder_to_right_elbow'],
        right_wrist_mask=['right_wrist', 'right_elbow_to_right_wrist'],
        upper_torso_mask=_UPPER_TORSO,
        lower_torso_mask=_LOWER_TORSO,
        left_leg_mask=['left_knee', 'left_knee_to_left_hip',
                       'left_hip_to_right_hip'],
        right_leg_mask=['right_knee', 'right_knee_to_right_hip'],
        left_tibia_mask=['left_ankle_to_left_knee'],
        right_tibia_mask=['right_ankle_to_right_knee'],
        left_feet_mask=['left_ankle'],
        right_feet_mask=['right_ankle'],
    ),
}

_COCO_TABLES = {
    'cc6': OrderedDict(
        head=_HEAD_KP,
        torso=['left_shoulder', 'right_shoulder', 'left_hip', 'right_hip'],
        left_arm=['left_shoulder', 'left_elbow', 'left_wrist'],
        right_arm=['right_shoulder', 'right_elbow', 'right_wrist'],
        left_leg=['left_hip', 'left_knee', 'left_ankle'],
        right_leg=['right_hip', 'right_knee', 'right_ankle'],
    ),
}

GROUPING_STRATEGIES = {}
for _name, _table in _STRATEGY_TABLES.items():
    GROUPING_STRATEGIES[_name] = GroupingSpec(
        _name, _table, combine='sum' if _name == 'six_no' else 'max')
for _name, _table in _COCO_TABLES.items():
    GROUPING_STRATEGIES[_name] = GroupingSpec(_name, _table, source='coco')


def get_grouping(name):
    if name not in GROUPING_STRATEGIES:
        raise KeyError('unknown mask grouping strategy: {} (available: {})'
                       .format(name, sorted(GROUPING_STRATEGIES)))
    return GROUPING_STRATEGIES[name]


def grouping_matrix(name):
    """Static [C, K] combination matrix for a named strategy."""
    return get_grouping(name).matrix


def group_masks(masks, matrix, combine='max'):
    """Group raw confidence channels into K part masks.

    Args:
        masks: ``[N, C, H, W]`` raw confidence fields (C=36 for pifpaf).
        matrix: ``[C, K]`` membership matrix (numpy).
        combine: 'max' or 'sum' over member channels.

    Returns:
        ``[N, K, H, W]`` clipped to [0, 1]. 'max' takes the max over
        each part's member channels, which after the clip equals the JAX
        version's max over ``masks * matrix`` (non-members give 0).
    """
    matrix = np.asarray(matrix)
    if combine == 'sum':
        out = torch.einsum('nchw,ck->nkhw', masks.float(),
                           torch.as_tensor(matrix, device=masks.device))
    else:
        out = torch.stack([
            masks.index_select(1, torch.as_tensor(
                np.flatnonzero(matrix[:, k]), device=masks.device)
            ).amax(dim=1) for k in range(matrix.shape[1])], dim=1)
    return out.clamp(0.0, 1.0)


def group_masks_special(masks, name):
    """Strategies operating on raw masks rather than via a table."""
    if name == 'bs_fu_bb':
        # 36 singles + full-body max + full-bbox ones
        full_body = masks.amax(dim=1, keepdim=True)
        return torch.cat([masks, full_body, torch.ones_like(full_body)],
                         dim=1)
    raise KeyError(name)


def add_background_mask(masks, strategy='sum', softmax_weight=0.0,
                        mask_filtering_threshold=0.3):
    """Prepend a background channel and normalize across parts.

    Args:
        masks: ``[N, K, H, W]`` part masks in [0, 1].
        strategy: 'sum' | 'threshold' | 'diff_from_max'.
        softmax_weight: if > 0, sharpen with softmax(masks * w) over parts;
            otherwise sum-normalize.

    Returns:
        ``[N, K+1, H, W]`` with background at channel 0.
    """
    if strategy == 'sum':
        background = (1.0 - masks.sum(dim=1, keepdim=True)).clamp(0.0, 1.0)
    elif strategy == 'threshold':
        background = (masks.amax(dim=1, keepdim=True)
                      < mask_filtering_threshold).to(masks.dtype)
    elif strategy == 'diff_from_max':
        background = (1.0 - masks.amax(dim=1, keepdim=True)).clamp(0.0, 1.0)
    else:
        raise ValueError('Background mask combine strategy {} not supported'
                         .format(strategy))
    full = torch.cat([background, masks], dim=1)
    if softmax_weight > 0:
        return torch.softmax(full * softmax_weight, dim=1)
    return full / full.sum(dim=1, keepdim=True)


def pcb_stripe_masks(parts_num, height, width, dtype=torch.float32,
                     device=None):
    """K horizontal-stripe masks ``[K, H, W]``: stripe ``i`` covers the
    rows ``[round(i H / K), round((i + 1) H / K))`` (numpy's
    round-half-even, as the JAX version)."""
    bounds = np.round(np.arange(parts_num + 1) * height / parts_num) \
        .astype(int)
    rows = np.zeros((parts_num, height), dtype=np.float32)
    for i in range(parts_num):
        rows[i, bounds[i]:bounds[i + 1]] = 1.0
    return torch.as_tensor(rows, dtype=dtype, device=device)[:, :, None] \
        .expand(parts_num, height, width)


def identity_masks(height, width, dtype=torch.float32, device=None):
    """One all-ones mask ``[1, H, W]`` (BoT emulation)."""
    return torch.ones((1, height, width), dtype=dtype, device=device)


class _FixedSpec:
    def __init__(self, name, parts_num):
        self.name = name
        self.parts_num = parts_num
        self.parts_names = ['p{}'.format(p) for p in range(1, parts_num + 1)] \
            if parts_num > 1 or name != 'id' else ['id']


# registry mirroring masks_preprocess_all (masks_transforms/__init__.py:9-52)
masks_preprocess_pifpaf = {n: GROUPING_STRATEGIES[n] for n in _STRATEGY_TABLES}
masks_preprocess_pifpaf['bs_fu_bb'] = _FixedSpec('bs_fu_bb', 38)
masks_preprocess_coco = {'cc6': GROUPING_STRATEGIES['cc6']}
masks_preprocess_fixed = {'id': _FixedSpec('id', 1)}
for _n in range(2, 9):
    masks_preprocess_fixed['strp_{}'.format(_n)] = _FixedSpec('strp_{}'.format(_n), _n)
masks_preprocess_transforms = {**masks_preprocess_pifpaf, **masks_preprocess_coco}
masks_preprocess_all = {**masks_preprocess_pifpaf, **masks_preprocess_fixed,
                        **masks_preprocess_coco}


def compute_parts_num_and_names(cfg, dataset_masks_config=None):
    """Resolve cfg.model.bpbreid.masks.parts_num/parts_names from the chosen
    grouping strategy or the dataset's own mask metadata (ISP-style)
    (reference: masks_transforms/__init__.py:55-65).

    Deliberate divergence: when ``masks.type == 'stripes'`` (the PCB
    emulation mode of configs/bpbreid/pcb_*.yaml) the YAML's
    ``parts_num`` is kept. The reference clobbers it with the pifpaf
    ``preprocess`` strategy's count (its compute_parts_num_and_names
    never consults masks.type), which contradicts its own shipped PCB
    configs ('6 horizontal stripes' overwritten to 8 parts).
    """
    masks_cfg = cfg.model.bpbreid.masks
    if cfg.loss.name == 'part_based':
        if masks_cfg.type == 'stripes':
            masks_cfg.parts_names = [
                'p{}'.format(p) for p in range(1, masks_cfg.parts_num + 1)]
        elif ((dataset_masks_config is not None and dataset_masks_config[1])
                or masks_cfg.preprocess == 'none'):
            masks_cfg.parts_num = dataset_masks_config[0]
            masks_cfg.parts_names = [
                'p{}'.format(p) for p in range(1, masks_cfg.parts_num + 1)]
        else:
            spec = masks_preprocess_all[masks_cfg.preprocess]
            masks_cfg.parts_num = spec.parts_num
            masks_cfg.parts_names = list(spec.parts_names)
    return cfg
