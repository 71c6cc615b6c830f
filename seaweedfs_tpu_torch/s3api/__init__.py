"""The S3 wire protocol: the SigV4 client the remote tier uploads with.

The S3 gateway itself (`weed/s3api/`) is not ported yet.
"""
