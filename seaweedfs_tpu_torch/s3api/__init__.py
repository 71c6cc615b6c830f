"""S3-compatible gateway over the filer (`weed/s3api/`): the port of the JAX
package's ``s3api/``.

- ``s3api_server.S3ApiServer``: buckets as directories under ``/buckets``,
  objects proxied to the filer, multipart uploads under
  ``/buckets/.uploads``, ListObjects v1/v2, tagging, copies, bucket
  policies, browser POST uploads, and SelectObjectContent, which the
  filer's ``/_select`` runs on the card.
- ``auth``: IAM identities, SigV4 (header, presigned, streaming) and SigV2;
  ``policy_engine``: bucket policies; ``post_policy``: POST policies.
- ``s3_client.S3Client``: the SigV4 client (the remote tier's and the
  tests').
"""

from .auth import IAM, Identity  # noqa: F401
from .s3api_server import S3ApiServer  # noqa: F401
