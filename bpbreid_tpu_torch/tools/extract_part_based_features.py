"""Batch inference over a folder of person crops -> ``.npy`` features
for tracking pipelines (port of
bpbreid_tpu/tools/extract_part_based_features.py).

Writes, under ``output_folder``, for the folder's name ``<name>``:
``embeddings_<name>.npy`` ``[N, E, D]`` (the ``test_embeddings`` streams,
a part stream counting one per part), ``visibility_scores_<name>.npy``
``[N, E]`` float32, ``parts_masks_<name>.npy`` ``[N, Hf, Wf, K]`` (the
JAX package's channel-last layout) and ``image_list_<name>.txt``.
Arrays are saved float32 where the model computes in bfloat16, which
numpy has no type for.
"""
import glob
import os
import os.path as osp

import numpy as np
import torch

from bpbreid_tpu_torch.constants import PARTS, bn_correspondants
from bpbreid_tpu_torch.tools.feature_extractor import FeatureExtractor

__all__ = ['extract_reid_features']


def extract_reid_features(cfg, input_folder, output_folder, model=None,
                          engine=None, chunk_size=50, device=None):
    """Features of every ``.jpg`` and ``.png`` under ``input_folder``
    (recursively, in sorted order), ``chunk_size`` images a batch.
    ``device`` as ``FeatureExtractor``'s. Returns ``(embeddings,
    visibility, parts masks)`` as saved, or None when the folder holds
    no image."""
    extractor = FeatureExtractor(cfg, model=model, engine=engine,
                                 device=device)
    image_list = sorted(
        glob.glob(osp.join(input_folder, '**', '*.jpg'), recursive=True)
        + glob.glob(osp.join(input_folder, '**', '*.png'), recursive=True))
    if not image_list:
        print('No images found under {}'.format(input_folder))
        return None

    test_embeddings = cfg.model.bpbreid.test_embeddings
    all_embeddings, all_vis, all_masks = [], [], []
    for i in range(0, len(image_list), chunk_size):
        embeddings, visibility, _cls, _pix, _feat, masks = extractor(
            image_list[i:i + chunk_size])
        emb_list, vis_list = [], []
        for key in test_embeddings:
            e = embeddings[key]
            emb_list.append(e if e.dim() == 3 else e[:, None, :])
            v = visibility[bn_correspondants.get(key, key)]
            vis_list.append((v if v.dim() == 2 else v[:, None]).float())
        all_embeddings.append(
            torch.cat(emb_list, dim=1).float().cpu().numpy())
        all_vis.append(torch.cat(vis_list, dim=1).cpu().numpy())
        all_masks.append(
            masks[PARTS].permute(0, 2, 3, 1).float().cpu().numpy())

    name = osp.basename(osp.normpath(input_folder))
    os.makedirs(output_folder, exist_ok=True)
    emb = np.concatenate(all_embeddings)
    vis = np.concatenate(all_vis)
    msk = np.concatenate(all_masks)
    np.save(osp.join(output_folder, 'embeddings_{}.npy'.format(name)), emb)
    np.save(osp.join(output_folder,
                     'visibility_scores_{}.npy'.format(name)), vis)
    np.save(osp.join(output_folder, 'parts_masks_{}.npy'.format(name)), msk)
    with open(osp.join(output_folder,
                       'image_list_{}.txt'.format(name)), 'w') as f:
        f.write('\n'.join(image_list))
    print('Saved features for {} images to {}'.format(len(image_list),
                                                      output_folder))
    return emb, vis, msk
