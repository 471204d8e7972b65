"""Analysis of the port's steps on one card (``repro/analysis``):

  costs     — counted operations, bytes, kernel calls and peak live
              memory of one call on meta tensors
  roofline  — the three-term roofline of those counts on one H100, and
              the in-step charge's, plain against fused
"""
