"""Embedding-stream key constants.

The framework manipulates five streams of embeddings per image — global,
foreground, background, concatenated-parts and per-part — plus their
batch-normalized ("BNNeck") counterparts. Keys mirror the reference
framework's public naming (reference: torchreid/utils/constants.py:1-19)
so configs and downstream consumers are drop-in compatible.
"""

GLOBAL = 'globl'
FOREGROUND = 'foreg'
BACKGROUND = 'backg'
CONCAT_PARTS = 'conct'
PARTS = 'parts'
BN_GLOBAL = 'bn_globl'
BN_FOREGROUND = 'bn_foreg'
BN_BACKGROUND = 'bn_backg'
BN_CONCAT_PARTS = 'bn_conct'
BN_PARTS = 'bn_parts'
PIXELS = 'pixls'

# map from the BN-stream key to its raw-stream key (visibility scores are
# shared between the two).
bn_correspondants = {
    BN_GLOBAL: GLOBAL,
    BN_FOREGROUND: FOREGROUND,
    BN_BACKGROUND: BACKGROUND,
    BN_CONCAT_PARTS: CONCAT_PARTS,
    BN_PARTS: PARTS,
}


def get_test_embeddings_names(parts_names, test_embeddings):
    """Human-readable column names for the test-embedding streams used at
    eval time (reference: torchreid/utils/constants.py:21-34)."""
    names = []
    if GLOBAL in test_embeddings or BN_GLOBAL in test_embeddings:
        names.append('global')
    if FOREGROUND in test_embeddings or BN_FOREGROUND in test_embeddings:
        names.append('foreground')
    if CONCAT_PARTS in test_embeddings or BN_CONCAT_PARTS in test_embeddings:
        names.append('concatenated')
    if PARTS in test_embeddings or BN_PARTS in test_embeddings:
        names = names + list(parts_names)
    return names
