"""The recsys family: CTR models (Wide&Deep, DLRM, DCN-v2) over a shared
sparse-feature embedding stack, and BERT4Rec."""
