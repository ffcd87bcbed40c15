"""The PifPaf part groupings of the reference repo
(``torchreid/data/masks_transforms/pifpaf_mask_transform.py``) that the
benchmark's configurations use: each part mask is the largest of its
member confidence fields, clipped to [0, 1]."""
import torch

__all__ = ['PIFPAF_PARTS', 'GROUPINGS', 'group_masks']

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
# the 36 channels of a PifPaf confidence-field file, in order
PIFPAF_PARTS = PIFPAF_KEYPOINTS + PIFPAF_JOINTS

GROUPINGS = {
    'five_v': [
        ('head_mask', ['nose', 'left_eye', 'right_eye', 'left_ear',
                       'right_ear', 'left_eye_to_right_eye',
                       'nose_to_left_eye', 'nose_to_right_eye',
                       'left_eye_to_left_ear', 'right_eye_to_right_ear',
                       'left_ear_to_left_shoulder',
                       'right_ear_to_right_shoulder']),
        ('upper_arms_torso_mask', ['left_elbow', 'right_elbow',
                                   'left_shoulder_to_left_elbow',
                                   'right_shoulder_to_right_elbow',
                                   'left_shoulder', 'right_shoulder',
                                   'left_shoulder_to_right_shoulder']),
        ('lower_arms_torso_mask', ['left_wrist', 'right_wrist',
                                   'left_elbow_to_left_wrist',
                                   'right_elbow_to_right_wrist',
                                   'left_hip', 'right_hip',
                                   'right_shoulder_to_right_hip']),
        ('legs_mask', ['left_hip', 'right_hip', 'left_knee', 'right_knee',
                       'left_ankle_to_left_knee', 'left_knee_to_left_hip',
                       'right_ankle_to_right_knee',
                       'right_knee_to_right_hip']),
        ('feet_mask', ['left_ankle', 'right_ankle']),
    ],
}


def group_masks(fields, name):
    """``[N, 36, H, W]`` PifPaf fields -> ``[N, K, H, W]`` part masks."""
    index = {c: i for i, c in enumerate(PIFPAF_PARTS)}
    return torch.stack([fields[:, [index[c] for c in members]].amax(dim=1)
                        for _, members in GROUPINGS[name]],
                       dim=1).clamp(0.0, 1.0)
