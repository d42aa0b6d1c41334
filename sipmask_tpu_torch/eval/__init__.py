"""COCO evaluation of the port: RLE codec, mask operations, result
post-processing and the COCOeval protocol."""
